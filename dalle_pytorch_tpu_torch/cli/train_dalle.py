"""Train the DALL-E transformer (counterpart of `dalle_pytorch_tpu/cli/train_dalle.py`).

    python -m dalle_pytorch_tpu_torch.cli.train_dalle --image_text_folder DIR --vae_path VAE.npz
    python -m dalle_pytorch_tpu_torch.cli.train_dalle --image_text_folder 'shards/*.tar' --wds --vae_path VAE.npz
    python -m dalle_pytorch_tpu_torch.cli.train_dalle --resume auto|PATH [--image_text_folder DIR]
    python -m dalle_pytorch_tpu_torch.cli.train_dalle --dummy_run [N] [--device cpu]

The path: a folder of images and captions or local tar shards
(`data/loader.py`, PNG through the port's own decoder) -> the frozen VAE's
codes -> the DALL-E weighted cross-entropy -> backward through the flash
kernels -> global-norm clipping, the bad-step guard, Adam (optax's, on
groups of leaves; `--lr_decay` chains reduce-on-plateau after it) -> v3
checkpoints that the JAX package's `load_checkpoint` reads: `<name>.pt` at
the start and at each epoch's end, `<name>_step<N>.npz` every
`--save_every_n_steps` (the newest `--keep_n_checkpoints` kept).  Each
checkpoint holds the weights, the VAE, the optimizer state in the JAX
layout and the data cursor, so that `--resume` continues a run batch for
batch, and resumes the JAX CLI's checkpoints too.  It runs on the card
unless `--device cpu` is given.

The VAE (`reconstitute_vae`, the JAX CLI's): a resumed checkpoint's, of
any family; `--vae_path`, a trained DiscreteVAE (v3, a torch-reference
`vae.pt`, or a pre-v3 file under `--allow_legacy_pickle`); `--taming`, the
taming VQGAN from `--vqgan_model_path` and `--vqgan_config_path`, or the
published one through the pretrained cache (`models/pretrained.py`);
otherwise OpenAI's dVAE through the same cache, which a machine with no
network must hold already (`DALLE_PYTORCH_TPU_CACHE`).  `--dalle_path` also
takes a torch-reference `dalle.pt` (its VQGanVAE's yaml through
`--vqgan_config_path`), trained on with a fresh optimizer.

The model flags and their defaults are the JAX CLI's: without
`--rotary_emb` the model learns its positions, as the JAX CLI's default
model does.  `--dummy_run N` trains N synthetic batches (random captions
and pixels from `--seed`, a tiny random VAE, a deliberately ragged last
batch) on the JAX CLI's dummy model; explicit model flags win over its
tiny defaults.  `--execution remat --remat_policy flash_qkv` keeps the
flash forward's outputs and the qkv projection across each layer;
`--reversible` (or `--execution reversible`) rebuilds each layer's input in
the backward instead; `--stable_softmax` trains the stable model, and
`--shared_attn_ids` / `--shared_ff_ids` share layers' weights by id;
`--param_dtype bfloat16` stores the parameters in bf16 with no f32 master,
Adam's math on f32 views and stochastic-rounded updates.  Flags whose
machinery is not ported exit with a message naming their ROADMAP.md item.

Across processes, one per card, under torchrun (NCCL; gloo with --device
cpu):

    python -m torch.distributed.run --nproc_per_node N -m dalle_pytorch_tpu_torch.cli.train_dalle \
        --distributed_backend torch [--mesh_fsdp F --zero_stage 3] [--mesh_tp T] ...

`--mesh_dp/fsdp/tp` and `--zero_stage` shard the step
(`parallel/train_step.py`); `--mesh_pp P` pipelines the layers over P stages
(`--pp_num_micro`, `--pp_interleave`; the port unrolls its layers, so no
`--scan_layers` is needed or taken); `--mesh_sp S`, as in the JAX CLI,
repeats the step on S ranks unless the model's config shards its sequence
(`seq_shard_axis="sp"`, with `attn_kernel="ring"` for ring attention); `--batch_size` is the global batch, each data
rank reading its share (the dummy run's batches are drawn whole on every
rank, which takes its rows, so that the losses are the one-process run's);
the loss printed is the step's mean over the data ranks, and only rank 0 prints
records and writes checkpoints, the full state gathered onto it into the same v3
file with the mesh in its `topology` meta.

Telemetry is on by default, as in the JAX CLI (`--telemetry DIR`, default
`<output>.telemetry`; `--telemetry off` writes nothing): the loop's spans
(`data_wait`, `dispatch`, `block`, `log`, `checkpoint`, `flops_crosscheck`)
and per-step records in `<name>.spans.jsonl`, the HBM ledger priced before
the model reaches the card (printed, and a `mem_ledger` event), the FLOPs
crosscheck on the first step and after a rebuild and the memory crosscheck
(the step's peak, the in-place audit) on the step after it, the headroom
monitor (`--hbm_headroom_frac`) and the profiler captures on an alarm
(`--profile_on_alarm`), on `--profile_steps A:B` or on SIGUSR2, under
`traces/`.  Render a directory with
`python -m dalle_pytorch_tpu_torch.tools.telemetry_report DIR` and
`python -m dalle_pytorch_tpu_torch.tools.memory_report DIR`.  An
out-of-memory error writes `oom_report_*.txt` there and exits 77
(`resilience.EXIT_OOM`): a supervisor must not restart that config.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import os
import statistics
import sys
import time
from glob import glob
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from dalle_pytorch_tpu_torch.cli.common import (
    add_mesh_flags,
    build_mesh,
    refuse,
    start_backend,
    warn_vocab_mismatch,
)
from dalle_pytorch_tpu_torch.data import loader
from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
from dalle_pytorch_tpu_torch.models import pretrained, torch_port
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig, init_dalle
from dalle_pytorch_tpu_torch.observability import capture as capture_mod
from dalle_pytorch_tpu_torch.observability import memory as memory_mod
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability import telemetry
from dalle_pytorch_tpu_torch.observability.cuda import meta_module
from dalle_pytorch_tpu_torch.optim.grouped import Adam
from dalle_pytorch_tpu_torch.optim.plateau import ReduceOnPlateau
from dalle_pytorch_tpu_torch.parallel import backend as backend_mod
from dalle_pytorch_tpu_torch.parallel import registry as registry_mod
from dalle_pytorch_tpu_torch.parallel.mesh import active_mesh, mesh_context
from dalle_pytorch_tpu_torch.parallel.sharding import Placement
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, TrainState, make_train_step
from dalle_pytorch_tpu_torch.training import resume as resume_mod
from dalle_pytorch_tpu_torch.training.logging import MetricLogger
from dalle_pytorch_tpu_torch.training.profiling import dalle_step_flops, matmul_param_count, mfu
from dalle_pytorch_tpu_torch.version import __version__

# flag -> (what it needs that the port does not have yet, its ROADMAP.md Queue 1 item)
_WAITING = {
    "chinese": ("the Chinese BERT tokenizer (`transformers`)", 4),
    "hug": ("the Hugging Face tokenizer (`tokenizers`)", 4),
    "sample_every_n_steps": ("sample logging (`training/logging.py`)", 8),
}

# the JAX CLI's model defaults, and its `_apply_dummy_run_defaults` tiny model
_MODEL_DEFAULTS = dict(dim=512, depth=2, heads=8, dim_head=64, text_seq_len=256)
_DUMMY_MODEL = dict(dim=64, depth=2, heads=2, dim_head=16, text_seq_len=16, num_text_tokens=256)
_DUMMY_VAE = dict(image_size=32, num_tokens=128, codebook_dim=32, num_layers=2,
                  num_resnet_blocks=0, hidden_dim=16)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--vae_path", type=str, default=None,
                       help="a trained DiscreteVAE: a v3 checkpoint or a torch-reference vae.pt")
    group.add_argument("--dalle_path", type=str, default=None,
                       help="a DALL-E checkpoint to resume: the port's, the JAX CLI's or a torch-reference "
                            "dalle.pt")
    parser.add_argument("--taming", action="store_true", help="use a pretrained taming VQGAN as the image tokenizer")
    parser.add_argument("--vqgan_model_path", type=str, default=None,
                        help="taming checkpoint (.ckpt); the published default through the cache when omitted")
    parser.add_argument("--vqgan_config_path", type=str, default=None,
                        help="taming config yaml matching --vqgan_model_path")
    parser.add_argument("--allow_legacy_pickle", action="store_true",
                        help="permit loading pre-v3 (pickled-treedef) checkpoints: trusted sources only")
    parser.add_argument("--image_text_folder", type=str, default=None,
                        help="folder of images and same-stem .txt captions, or a glob of local .tar shards with "
                             "--wds (required unless --dummy_run or a resume)")
    parser.add_argument("--wds", action="store_true", help="read --image_text_folder as tar shards")
    parser.add_argument("--truncate_captions", action="store_true")
    parser.add_argument("--random_resize_crop_lower_ratio", type=float, default=0.75)
    parser.add_argument("--bpe_path", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=4, help="decode/crop threads (0 = in the loop)")
    parser.add_argument("--dummy_run", "--dummy-run", type=int, nargs="?", const=6, default=None,
                        metavar="N", help="train N steps (default 6) of synthetic batches")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--dalle_output_file_name", type=str, default="dalle")
    parser.add_argument("--seed", type=int, default=42)
    for name in ("dim", "depth", "heads", "dim_head", "text_seq_len", "num_text_tokens"):
        parser.add_argument(f"--{name}", type=int, default=None)
    parser.add_argument("--shift_tokens", action="store_true", help="use token shift")
    parser.add_argument("--rotary_emb", action="store_true",
                        help="rotary positions (default: learned text and axial image positions)")
    parser.add_argument("--attn_types", type=str, default="full",
                        help="comma-separated attention types, cycled over depth: "
                             "full, axial_row, axial_col, conv_like, sparse")
    parser.add_argument("--sparse_per_head", action="store_true",
                        help="sparse layers draw one random-block layout per head")
    parser.add_argument("--share_input_output_emb", action="store_true",
                        help="tie the text and image embeddings to the logits weight")
    parser.add_argument("--attn_dropout", type=float, default=0.0)
    parser.add_argument("--ff_dropout", type=float, default=0.0)
    parser.add_argument("--loss_img_weight", type=int, default=7)
    parser.add_argument("--reversible", action="store_true",
                        help="reversible execution (the default --execution when it is not given)")
    parser.add_argument("--execution", type=str, default=None, choices=["sequential", "remat", "reversible"])
    parser.add_argument("--remat_policy", type=str, default="full",
                        choices=["full", "flash", "flash_qkv", "flash_qkv_ff"],
                        help="selective remat save policy for --execution remat")
    parser.add_argument("--param_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                        help="param STORAGE dtype. bfloat16 = no f32 master copy (halves resident param "
                             "memory; T5-style), optimizer math in f32, stochastic-rounded weight updates")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--save_every_n_steps", type=int, default=None,
                        help="step-checkpoint cadence (default 1000, 0 under --dummy_run; 0 disables)")
    parser.add_argument("--keep_n_checkpoints", type=int, default=None, help="keep the newest N step files")
    parser.add_argument("--resume", type=str, default=None, metavar="auto|PATH",
                        help="'auto': the newest checkpoint next to the output file that loads (a fresh start "
                             "when there is none); a path resumes from that checkpoint")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="batch size (default 4; --dummy_run: 2 x the devices the run uses)")
    parser.add_argument("--ga_steps", type=int, default=1, help="gradient accumulation steps")
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--clip_grad_norm", type=float, default=0.5)
    parser.add_argument("--lr_decay", action="store_true",
                        help="reduce on plateau (factor 0.5, patience 10, cooldown 10, min lr 1e-6)")
    parser.add_argument("--bf16", action="store_true", help="bf16 compute")
    parser.add_argument("--loss_scale", type=str, default=None, help="a static scale or 'dynamic'")
    parser.add_argument("--stable_softmax", action="store_true",
                        help="the stable model: the embedding blend, the stable softmax and divide_max")
    parser.add_argument("--shared_attn_ids", type=str, default=None,
                        help="comma-separated attention ids, cycled over depth (layers of one id share weights)")
    parser.add_argument("--shared_ff_ids", type=str, default=None,
                        help="comma-separated feed-forward ids, cycled over depth")
    # not ported: each exits naming its ROADMAP.md item
    for name in ("chinese", "hug"):
        parser.add_argument(f"--{name}", action="store_true")
    parser.add_argument("--sample_every_n_steps", type=int, default=None)
    parser.add_argument("--log_every_n_steps", type=int, default=10,
                        help="telemetry flush cadence (the per-step records print every step)")
    parser.add_argument("--flops_profiler", action="store_true",
                        help="capture a torch.profiler trace of step 199 into ./profile_trace.json and stop at 200")
    # telemetry (observability/): on by default, JSONL only
    parser.add_argument("--telemetry", type=str, default=None, metavar="DIR",
                        help="telemetry directory (spans JSONL, hang dumps, traces, OOM reports); default "
                             "<output>.telemetry; 'off' disables it")
    parser.add_argument("--telemetry_heartbeat_s", type=float, default=900.0,
                        help="hang-monitor deadline: no step completed within it dumps thread stacks, the last "
                             "spans and the allocator's stats to the telemetry directory (0 disables)")
    parser.add_argument("--telemetry_sync", type=int, default=1,
                        help="1: synchronise the card after each step, so that its time splits into data_wait / "
                             "dispatch / block; 0: never (block reads 0)")
    parser.add_argument("--profile_on_alarm", type=int, default=3, metavar="N",
                        help="capture a torch.profiler trace of the next N steps when an alarm fires (one capture "
                             "per 15 min, 2 a run; under <telemetry>/traces; 0 disables); SIGUSR2 asks for one")
    parser.add_argument("--profile_steps", type=str, default=None, metavar="A:B",
                        help="capture a torch.profiler trace of steps [A, B) into <telemetry>/traces")
    parser.add_argument("--hbm_headroom_frac", type=float, default=0.9, metavar="FRAC",
                        help="alarm (once an episode) when the allocator's bytes in use cross FRAC of the card "
                             "(0 disables); with --profile_on_alarm it captures the next steps")
    add_mesh_flags(parser, pipeline=True)
    backend_mod.wrap_arg_parser(parser)
    return parser


def _refuse_waiting_flags(args) -> None:
    for flag, (machinery, item) in _WAITING.items():
        if getattr(args, flag) not in (None, False, 0):
            raise refuse(f"--{flag}: {machinery}", item)


def _apply_dummy_run_defaults(args) -> None:
    """The JAX CLI's `_apply_dummy_run_defaults`: its tiny model (explicit
    model flags win here), a batch of 2 x the devices the run uses (its
    processes), one epoch, at most 2 workers, quiet cadences unless
    given."""
    for name, value in _DUMMY_MODEL.items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    if args.batch_size is None:
        args.batch_size = 2 * max(args.num_processes or int(os.environ.get("WORLD_SIZE", 1)), 1)
    args.epochs = 1
    args.num_workers = min(args.num_workers, 2)
    if args.save_every_n_steps is None:
        args.save_every_n_steps = 0


def resolve_args(argv=None) -> argparse.Namespace:
    """Parse and check the flags, then fill the defaults the JAX CLI's
    `main` fills: the dummy run's, else the model defaults, a save cadence
    of 1000 and a batch of 4."""
    args = build_parser().parse_args(argv)
    _refuse_waiting_flags(args)
    if args.resume is not None and args.dalle_path is not None:
        raise SystemExit("--resume and --dalle_path are mutually exclusive")
    if args.dummy_run is not None:
        _apply_dummy_run_defaults(args)
    elif args.image_text_folder is None:
        raise SystemExit("--image_text_folder is required (unless --dummy_run)")
    for name, value in _MODEL_DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    if args.save_every_n_steps is None:
        args.save_every_n_steps = 1000
    if args.batch_size is None:
        args.batch_size = 4
    if args.wds and args.dummy_run is None:
        loader.refuse_remote_shards(loader.expand_shard_spec(args.image_text_folder))
    return args


def get_tokenizer(args):
    """The JAX CLI's choice: a `--bpe_path` json is a Hugging Face BPE, any
    other file a youtokentome model; the default is CLIP's BPE."""
    if args.bpe_path is None:
        return tokenizer_mod.tokenizer
    try:
        if Path(args.bpe_path).suffix == ".json":
            return tokenizer_mod.HugTokenizer(args.bpe_path)
        return tokenizer_mod.YttmTokenizer(args.bpe_path)
    except ImportError as e:
        raise SystemExit(f"--bpe_path {args.bpe_path}: its tokenizer needs the {e.name} package, which this machine "
                         "lacks (ROADMAP.md Queue 1 item 4)") from e


def model_config(args, vae_cfg, tokenizer) -> DALLEConfig:
    """The DALL-E config of the flags, as the JAX CLI builds it
    (`num_text_tokens` from the tokenizer's vocab unless given)."""
    return DALLEConfig.from_vae(
        vae_cfg, dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        text_seq_len=args.text_seq_len, num_text_tokens=args.num_text_tokens or tokenizer.vocab_size,
        reversible=args.reversible, attn_dropout=args.attn_dropout, ff_dropout=args.ff_dropout,
        execution=args.execution, remat_policy=args.remat_policy, loss_img_weight=args.loss_img_weight,
        attn_types=tuple(args.attn_types.split(",")), sparse_per_head=args.sparse_per_head,
        stable=args.stable_softmax, shift_tokens=args.shift_tokens, rotary_emb=args.rotary_emb,
        shared_attn_ids=_parse_ids(args.shared_attn_ids), shared_ff_ids=_parse_ids(args.shared_ff_ids),
        share_input_output_emb=args.share_input_output_emb,
    )


def _parse_ids(text: Optional[str]):
    """The JAX CLI's `_parse_ids`: "0,1,0" -> (0, 1, 0), None -> None."""
    if text is None:
        return None
    return tuple(int(x) for x in text.split(","))


def dummy_batches(seed: int, n: int, batch_size: int, cfg: DALLEConfig, vae_cfg,
                  epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """n synthetic batches of random captions and pixels, the JAX dummy
    run's draws (`RandomState(seed + epoch)`); the last one is half size
    when n >= 2."""
    rs = np.random.RandomState(seed + epoch)
    for i in range(n):
        bs = batch_size // 2 if i == n - 1 and n >= 2 and batch_size >= 2 else batch_size
        yield {
            "text": rs.randint(0, cfg.num_text_tokens, (bs, cfg.text_seq_len)).astype(np.int32),
            "image": rs.rand(bs, vae_cfg.image_size, vae_cfg.image_size, 3).astype(np.float32),
        }


def data_iterator(args, cfg: DALLEConfig, vae_cfg, tokenizer, share: int = 0, shares: int = 1):
    """data_iter(epoch, skip) -> the epoch's batches from batch `skip` on,
    as the JAX CLI builds it: synthetic, tar shards (the skipped batches
    read and dropped: a stream has no random access) or the folder (the
    skipped ones never decoded).  On a mesh a data rank (`share` of
    `shares`) reads batches of batch_size / shares from its share of the
    items; the synthetic batches are whole, each rank taking its rows in
    the step."""
    local = args.batch_size // shares
    if args.dummy_run is not None:
        return lambda epoch, skip=0: itertools.islice(
            dummy_batches(args.seed, args.dummy_run, args.batch_size, cfg, vae_cfg, epoch), skip, None)
    if args.wds:
        shards = sorted(glob(args.image_text_folder))
        if not shards:
            raise SystemExit(f"no tar shards match {args.image_text_folder}")

        def shard_batches(epoch, skip=0):
            stream = loader.iterate_tar_shards(shards, vae_cfg.image_size, cfg.text_seq_len, tokenizer,
                                               truncate_captions=args.truncate_captions, seed=args.seed + epoch,
                                               num_workers=args.num_workers, process_index=share,
                                               process_count=shares)
            return itertools.islice(loader.batch_tar_stream(stream, local), skip, None)

        return shard_batches
    dataset = loader.TextImageDataset(args.image_text_folder, text_len=cfg.text_seq_len,
                                      image_size=vae_cfg.image_size, truncate_captions=args.truncate_captions,
                                      resize_ratio=args.random_resize_crop_lower_ratio, tokenizer=tokenizer,
                                      shuffle=True)
    if not len(dataset):
        raise SystemExit(f"{args.image_text_folder} holds no image with a same-stem caption file")
    return lambda epoch, skip=0: loader.iterate_batches(dataset, local, seed=args.seed + epoch,
                                                        num_workers=args.num_workers, skip_batches=skip,
                                                        process_index=share, process_count=shares)


def dalle_loss_fn(model: DALLE, vae: torch.nn.Module, compute_dtype: torch.dtype):
    """loss_fn(params, batch, generator) for `make_train_step`: raw pixels
    (batch["image"], (B, H, W, C) in [0, 1]) through the frozen VAE, of any
    family (`vae_registry`), to codes, then the DALL-E loss on
    batch["text"] with `params` in place of the model's parameters.  The
    VAE encodes in the compute dtype, as the JAX CLI runs it."""
    encoder = vae if compute_dtype == torch.float32 else copy.deepcopy(vae).to(compute_dtype)

    def loss_fn(params, batch, generator):
        with torch.no_grad():
            codes = vae_registry.get_codebook_indices(encoder, batch["image"].to(compute_dtype))
        return functional_call(model, params, (batch["text"], codes),
                               {"return_loss": True, "generator": generator})

    return loss_fn


def dalle_meta_step(cfg: DALLEConfig, vae: torch.nn.Module, batch: dict,
                    compute_dtype: torch.dtype) -> Callable[[], None]:
    """One training step of `cfg` at `batch`'s shapes on the meta device,
    for the measured FLOPs count (`observability/cuda.step_cost_analysis`):
    a model of `cfg` and a copy of the frozen `vae` there, the loss and its
    backward in the compute dtype as `dalle_loss_fn` runs them — the VAE's
    encode, the remat recompute, the flash kernels the card would launch —
    with nothing allocated and nothing launched."""
    with torch.device("meta"):
        model = DALLE(cfg)
    params = {n: p.detach().to(compute_dtype).requires_grad_() for n, p in model.train().named_parameters()}
    shapes = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    loss_fn = dalle_loss_fn(model, meta_module(vae), compute_dtype)
    return lambda: loss_fn(params, shapes, None).backward()


def write_vae_checkpoint(path: str, vae: vae_mod.DiscreteVAE) -> None:
    """The VAE checkpoint the JAX package's `train_vae` writes, which
    `--vae_path` reads: its weights tree and its config as `hparams`."""
    save_checkpoint(path, {"weights": weights.vae_tree(vae.state_dict(), vae.cfg)},
                    {"hparams": vae.cfg.to_dict(), "version": __version__})


def load_vae_checkpoint(path: str, device, allow_legacy_pickle: bool = False) -> torch.nn.Module:
    """`--vae_path`: a trained DiscreteVAE, as a v3 checkpoint (a pre-v3 one
    with `allow_legacy_pickle`) or a torch-reference `vae.pt` (converted on
    load), as JAX `reconstitute_vae` reads it."""
    if not Path(path).exists():
        raise SystemExit(f"--vae_path {path} does not exist")
    if torch_port.is_torch_checkpoint(path):
        params, cfg = torch_port.load_reference_vae_checkpoint(path)
        return weights.load_vae(params, cfg, device)
    trees, meta = load_checkpoint(path, allow_legacy_pickle=allow_legacy_pickle)
    cfg = vae_mod.DiscreteVAEConfig.from_dict(meta["hparams"])
    return weights.load_vae(trees["weights"], cfg, device)


def reconstitute_vae(args, device, resumed=None) -> torch.nn.Module:
    """The frozen VAE that tokenizes the training images (JAX
    `reconstitute_vae`): the resumed checkpoint's (`resumed`, its (trees,
    meta)) of any family, `--vae_path`, `--taming` (the VQGAN from its
    paths or the published one), or OpenAI's dVAE through the pretrained
    cache.  A fetch that fails exits naming the cache directory."""
    if resumed is not None:
        trees, meta = resumed
        if "vae_weights" not in trees:
            raise SystemExit("the resumed checkpoint holds no VAE weights")
        cfg = vae_registry.config_from_meta(meta.get("vae_class_name", "DiscreteVAE"), meta["vae_params"])
        return weights.load_vae(trees["vae_weights"], cfg, device)
    if args.vae_path is not None:
        return load_vae_checkpoint(args.vae_path, device, args.allow_legacy_pickle)
    if (args.vqgan_model_path or args.vqgan_config_path) and not args.taming:
        raise SystemExit("--vqgan_model_path/--vqgan_config_path require --taming "
                         "(otherwise they would be silently ignored)")
    if args.taming:
        if args.vqgan_model_path is not None and not Path(args.vqgan_model_path).exists():
            raise SystemExit(f"--vqgan_model_path {args.vqgan_model_path} does not exist")
        try:
            params, cfg = pretrained.load_vqgan_pretrained(args.vqgan_model_path, args.vqgan_config_path)
        except ValueError as e:
            raise SystemExit(f"--taming: {e}") from e
        except OSError as e:
            raise SystemExit(f"--taming: the published VQGAN is not in the cache {pretrained.default_cache_dir()} "
                             f"and fetching it failed ({e!r})") from e
        return weights.load_vae(params, cfg, device)
    print("using OpenAI's pretrained VAE for encoding images to tokens", flush=True)
    try:
        params, cfg = pretrained.load_openai_vae_pretrained()
    except OSError as e:  # urllib's URLError is an OSError
        raise SystemExit(f"no --vae_path: OpenAI's pretrained dVAE is not in the cache "
                         f"{pretrained.default_cache_dir()} (DALLE_PYTORCH_TPU_CACHE) and fetching it failed "
                         f"({e!r})") from e
    return weights.load_vae(params, cfg, device)


def save_dalle(path: str, model: DALLE, vae: torch.nn.Module, state: TrainState, epoch: int,
               global_step: int, data_state: Optional[dict] = None, topology: Optional[dict] = None,
               memory_state: Optional[dict] = None) -> None:
    """The checkpoint the JAX CLI writes (`build_model_payload`), in v3:
    weights, vae_weights (the VAE's family's tree) and opt_state (the JAX
    layout, from the first update on); hparams, vae_class_name,
    vae_params, epoch, global_step, data_state, the run's `topology` and
    the headroom monitor's `memory_state`.
    `state` is a one-process state: a sharded run passes its full state
    (`step_fn.full_state`)."""
    cfg = model.cfg
    trees = {
        "weights": weights.dalle_tree({**model.state_dict(), **state.params}, cfg),
        "vae_weights": weights.vae_tree(vae.state_dict(), vae.cfg),
        "opt_state": resume_mod.optimizer_bundle(state, cfg),
    }
    vae_class_name, vae_params = vae_registry.config_to_meta(vae.cfg)
    # the pipeline's knobs follow each run's mesh (the topology records them), and the JAX package's
    # forward refuses pipeline_axis on the unscanned layers the port writes
    hparams = dataclasses.replace(cfg, pipeline_axis=None, pp_num_micro=None, pp_interleave=1).to_dict()
    meta = {"hparams": hparams, "vae_params": vae_params, "vae_class_name": vae_class_name,
            "epoch": epoch, "global_step": int(global_step), "version": __version__, "data_state": data_state}
    if topology is not None:
        meta["topology"] = topology
    if memory_state is not None:
        meta["memory_state"] = memory_state
    save_checkpoint(path, trees, meta)


def _resume_source(args, out_file: str) -> Optional[str]:
    """The checkpoint a run continues: `--dalle_path`, `--resume PATH`, or
    under `--resume auto` the newest one next to the output file that loads
    (None: a fresh start)."""
    if args.resume == "auto":
        found = resume_mod.find_latest_valid_checkpoint(out_file)
        print(f"[resume] --resume auto: {'resuming from ' + found if found else 'no checkpoint next to ' + out_file}"
              f"{'' if found else '; starting fresh'}", flush=True)
        return found
    path = args.resume or args.dalle_path
    if path is not None and not Path(path).exists():
        raise SystemExit(f"checkpoint {path} does not exist")
    if path is not None and Path(path).is_dir():
        raise refuse(f"{path}: resuming a sharded checkpoint", 8)
    return path


def _load_resumed(args, source: str):
    """(trees, meta) of the checkpoint a run continues.  A torch-reference
    `dalle.pt` is converted (its VQGanVAE's yaml from --vqgan_config_path)
    into the trees and meta of a checkpoint without an optimizer state: the
    reference's torch Adam state does not carry over."""
    if not torch_port.is_torch_checkpoint(source):
        return load_checkpoint(source, allow_legacy_pickle=args.allow_legacy_pickle)
    ref = torch_port.read_reference_dalle(source, args.vqgan_config_path)
    print(f"[resume] resuming from reference checkpoint {source} (epoch {ref['epoch']}, fresh optimizer state)",
          flush=True)
    vae_class_name, vae_params = vae_registry.config_to_meta(ref["vae_config"])
    return ({"weights": ref["params"], "vae_weights": ref["vae_params"]},
            {"hparams": ref["config"].to_dict(), "vae_class_name": vae_class_name, "vae_params": vae_params,
             "epoch": ref["epoch"]})


def main(argv=None) -> int:
    args = resolve_args(argv)
    be, device = start_backend(args)
    try:
        mesh, mesh_cfg = build_mesh(args, be, device)
        with mesh_context(mesh):  # the step is built on it
            return _train(args, be, device, mesh_cfg)
    finally:
        be.shutdown()


def _train(args, be, device, mesh_cfg) -> int:
    mesh = active_mesh()
    is_root = be.is_root_worker()
    torch.manual_seed(args.seed)
    out_file = f"{args.dalle_output_file_name}.pt"
    tokenizer = get_tokenizer(args)
    topology = registry_mod.topology_meta(dataclasses.asdict(mesh_cfg), device_count=be.get_world_size())
    if mesh_cfg.pp > 1:
        topology["pp_interleave"] = args.pp_interleave

    source = _resume_source(args, out_file)
    resumed = _load_resumed(args, source) if source is not None else None
    if resumed is None and args.dummy_run is not None:
        vae_cfg = vae_mod.DiscreteVAEConfig(**_DUMMY_VAE)
        vae = vae_mod.init_discrete_vae(vae_cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    else:  # the resumed checkpoint carries the VAE it trained with
        vae = reconstitute_vae(args, device, resumed)
        vae_cfg = vae.cfg

    # the pipeline follows this run's mesh, not the checkpoint's, as in the JAX CLI
    pipe = dict(pipeline_axis="pp" if args.mesh_pp > 1 else None, pp_num_micro=args.pp_num_micro,
                pp_interleave=args.pp_interleave)
    if resumed is not None:
        cfg = dataclasses.replace(DALLEConfig.from_dict(resumed[1]["hparams"]), **pipe)
    else:
        cfg = dataclasses.replace(model_config(args, vae_cfg, tokenizer), **pipe)
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    loss_scale = args.loss_scale if args.loss_scale in (None, "dynamic") else float(args.loss_scale)
    lowp = args.param_dtype == "bfloat16"
    settings = StepSettings(grad_accum=args.ga_steps, compute_dtype=compute_dtype,
                            clip_grad_norm=args.clip_grad_norm, loss_scale=loss_scale,
                            param_dtype=torch.bfloat16 if lowp else torch.float32, zero_stage=args.zero_stage)
    # the HBM ledger, priced before the model reaches the card: the
    # parameters' shapes from a model on the meta device, this rank's
    # placement on the mesh's shape (Adam's moments estimated), refreshed
    # from the live state at the memory crosscheck
    with torch.device("meta"):
        shapes = DALLE(cfg)
    shape_params = dict(shapes.named_parameters())
    placement = None if mesh is None else Placement(
        dataclasses.asdict(mesh_cfg), be.get_rank(), shape_params, args.zero_stage,
        paths=weights.dalle_param_paths(cfg), module=shapes)
    mem_ledger = memory_mod.dalle_step_memory(mesh, shape_params, None, cfg, args.batch_size, settings=settings,
                                              plan=placement, device=device)
    del shapes, shape_params, placement
    run = telemetry.RunTelemetry.from_args(args, args.dalle_output_file_name, mem_ledger, device, be.get_rank(),
                                           (resumed[1] if resumed is not None else {}).get("memory_state"))
    logger = None
    if run.tele is not None:
        logger = MetricLogger(run_name=Path(args.dalle_output_file_name).name, log_dir=run.dir, is_root=is_root)
        if is_root:
            print(f"[telemetry] spans + metrics + hang dumps -> {run.dir} (render with python -m "
                  "dalle_pytorch_tpu_torch.tools.telemetry_report)", flush=True)
    if is_root:
        fits = mem_ledger.get("fits")
        verdict = "fits" if fits else "DOES NOT FIT" if fits is not None else "capacity unknown"
        print("[memory] analytic HBM ledger: " + ", ".join(f"{r['name']}={r['bytes'] / 1e9:.2f}GB"
                                                          for r in mem_ledger["rows"])
              + f" per rank ({verdict}; dominant: {mem_ledger['dominant']})", flush=True)

    # where an out-of-memory error struck, for its report
    where = {"phase": "init", "ledger": mem_ledger,
             "context": {"global_step": None, "mesh": mem_ledger.get("mesh"), "batch_size": args.batch_size,
                         "ga_steps": args.ga_steps, "zero_stage": args.zero_stage}}
    try:
        with run.oom_exit(where, settings):
            if resumed is not None:
                model = weights.load_dalle(resumed[0]["weights"], cfg, device)
            else:
                model = init_dalle(cfg, torch.Generator(device=device).manual_seed(args.seed + 1), device)
            if is_root:
                warn_vocab_mismatch(cfg.num_text_tokens, tokenizer)
            model.train().requires_grad_(True)
            return _train_loop(args, be, device, mesh, is_root, topology, source, resumed, vae, vae_cfg, cfg, model,
                               settings, tokenizer, out_file, run, logger, where)
    finally:
        run.close()
        if logger is not None:
            logger.finish()


def _train_loop(args, be, device, mesh, is_root, topology, source, resumed, vae, vae_cfg, cfg, model, settings,
                tokenizer, out_file, run, logger, where) -> int:
    compute_dtype = settings.compute_dtype
    tele = run.tele
    # optax.adam's math on groups of leaves, whatever the storage; under
    # --lr_decay the JAX CLI's reduce_on_plateau chained after it
    plateau = ReduceOnPlateau(factor=0.5, patience=10, cooldown=10,
                              min_scale=1e-6 / args.learning_rate) if args.lr_decay else None
    init_fn, step_fn = make_train_step(dalle_loss_fn(model, vae, compute_dtype), Adam(args.learning_rate), settings,
                                       plateau=plateau, module=model,
                                       paths=weights.dalle_param_paths(cfg) if mesh is not None else None)
    n_params = sum(p.numel() for p in model.parameters())  # before init_fn keeps this rank's pieces
    n_matmul = matmul_param_count(dict(model.named_parameters()))
    state = init_fn(dict(model.named_parameters()), round_seed=args.seed)
    generator = torch.Generator().manual_seed(args.seed)  # dropout seeds, drawn on the host
    plan = step_fn.plan() if mesh is not None else None
    shares = 1 if plan is None else plan.D
    if args.batch_size % shares:
        raise SystemExit(f"--batch_size {args.batch_size} does not split over {shares} data ranks")
    data_iter = data_iterator(args, cfg, vae_cfg, tokenizer, 0 if plan is None else plan.data_coord, shares)

    meta = resumed[1] if resumed is not None else {}
    data_state = meta.get("data_state") or {}
    resume_epoch = data_state.get("epoch", meta.get("epoch", 0))
    pending_skip = data_state.get("epoch_batches", 0) or 0
    global_step = meta.get("global_step", 0) or 0
    if resumed is not None and "opt_state" in resumed[0]:
        full = state if plan is None else step_fn.full_template(state)
        try:
            resume_mod.restore_optimizer(full, resumed[0]["opt_state"], cfg)
            if plan is not None:
                step_fn.load_opt_state(state, full)
        except ValueError as e:
            if is_root:
                print(f"note: optimizer state not restored ({e}); starting a fresh optimizer", flush=True)
        del full
    gens = {"dropout": generator, "round": state.round_generator}
    for name, saved in (data_state.get("torch_generators") or {}).items():
        if gens.get(name) is not None:
            resume_mod.set_generator_state(gens[name], saved)
    state = dataclasses.replace(state, step=global_step)

    if is_root:
        print(json.dumps({"config": cfg.to_dict(), "params": n_params, "device": str(device),
                          "compute_dtype": str(compute_dtype).replace("torch.", ""), "param_dtype": args.param_dtype,
                          "batch_size": args.batch_size, "resumed_from": source, "epoch": resume_epoch,
                          "skip_batches": pending_skip, "topology": topology, "distributed": be.describe()}),
              flush=True)

    def save(path, epoch, ds_epoch, ds_batches, step=None, keep_n=None):
        # the one-process state, gathered onto the root alone
        with telemetry.span("checkpoint", path=str(path)):
            full = state if plan is None else step_fn.full_state(state)
            if is_root:
                ds = resume_mod.data_state_dict(ds_epoch, ds_batches, args.seed, gens)
                save_dalle(path, model, vae, full, epoch, global_step if step is None else step, ds, topology,
                           run.monitor.state_dict() if run.monitor is not None else None)
                if keep_n is not None:
                    resume_mod.rotate_checkpoints(str(Path(path).parent), resume_mod.rotation_glob(path), keep_n)
            be.local_barrier()

    def count_flops(batch):
        """The FLOPs crosscheck (at the first step, and after a rebuild):
        this rank's step at `batch`'s shapes counted on the meta device
        (`dalle_meta_step`), against the analytic FLOPs of this rank's
        rows.  On a mesh the count is of those rows through the whole
        model, as is the analytic side: it does not see the tp, sp or pp
        split."""
        analytic = dalle_step_flops(cfg, int(batch["text"].shape[0]), n_matmul, granularity="tile")
        _, ratio = tele.crosscheck_flops(dalle_meta_step(cfg, vae, batch, compute_dtype), analytic)
        if is_root and ratio is not None:
            print(f"[telemetry] measured/analytic FLOPs ratio: {ratio:.3f}", flush=True)

    def memory_step(batch, rows):
        """The step after the first (whose peak also holds the builds and
        the first-use buffers), its peak on the card against the ledger
        refreshed from the live state at the global batch `rows` (a new
        `mem_ledger` event where that changes it), and the in-place
        audit."""
        live = memory_mod.dalle_step_memory(mesh, state.params, state.opt_state, cfg, rows, settings=settings,
                                            plan=plan, device=device)
        if live["total_bytes"] != where["ledger"]["total_bytes"]:
            where["ledger"] = live
            run.publish_ledger(live)
        out, ratio = tele.crosscheck_memory(lambda: step_fn(state, batch, generator), where["ledger"],
                                            memory_mod.state_bytes(state), device=device)
        if is_root and ratio is not None:
            print(f"[memory] measured/analytic HBM ratio: {ratio:.3f} (analytic "
                  f"{where['ledger']['total_bytes'] / 1e9:.2f}GB per rank)", flush=True)
        return out

    t_window = time.perf_counter()
    window_start = global_step
    checked_builds = memory_at = None
    step_s = []
    save(out_file, resume_epoch, resume_epoch, pending_skip)
    for epoch in range(resume_epoch, args.epochs):
        skip_now, pending_skip = pending_skip, 0
        epoch_batches = skip_now
        batches = iter(data_iter(epoch, skip_now))
        while True:
            run.begin(global_step)
            t0 = time.perf_counter()
            with telemetry.span("data_wait"):
                batch = next(batches, None)
            if batch is None:
                run.abort()  # the wait that found the epoch's end
                break
            t_data = time.perf_counter()
            epoch_batches += 1
            batch = {"text": torch.from_numpy(batch["text"]).long().to(device),
                     "image": torch.from_numpy(batch["image"]).to(device)}
            # the global batch's rows: a dummy batch is whole on every rank, which takes its rows
            rows = int(batch["text"].shape[0]) * (1 if args.dummy_run is not None else shares)
            if plan is not None and args.dummy_run is not None:
                batch = step_fn.local_batch(batch)
            if args.flops_profiler and global_step == 199:
                capture_mod.start_trace("./profile_trace.json")
            where["phase"] = "train_step" if where["context"]["global_step"] is not None else "compile"
            where["context"]["global_step"] = global_step
            builds = tele.compile_watcher.recompiles if tele is not None and tele.compile_watcher else 0
            if tele is not None and checked_builds != builds:
                with telemetry.span("flops_crosscheck"):
                    count_flops(batch)
                checked_builds = builds
                memory_at = global_step + 1  # this step's peak holds what is built for it
            with telemetry.span("dispatch"):
                if global_step == memory_at:
                    state, metrics = memory_step(batch, rows)
                else:
                    state, metrics = step_fn(state, batch, generator)
            run.block()
            with telemetry.span("log"):
                record = {"step": state.step, "epoch": epoch, "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]), "skipped": metrics["skipped"],
                          "batch": rows, "step_s": time.perf_counter() - t_data, "data_s": t_data - t0}
                if "loss_scale" in metrics:
                    record["loss_scale"] = metrics["loss_scale"]
                if state.plateau is not None:
                    record["lr_scale"] = float(state.plateau.scale)
                if is_root:
                    print(json.dumps(record), flush=True)
                step_s.append(record["step_s"])
                obs_metrics.counter("train_steps").inc()
                if tele is not None and global_step % args.log_every_n_steps == 0:
                    dt = time.perf_counter() - t_window
                    tokens = args.batch_size * cfg.total_seq_len * (global_step - window_start + 1)
                    obs_metrics.gauge("tokens_per_sec").set(tokens / max(dt, 1e-9))
                    t_window, window_start = time.perf_counter(), global_step + 1
                    run.flush(logger, step=global_step)
            if args.save_every_n_steps and global_step and global_step % args.save_every_n_steps == 0:
                step_file = f"{args.dalle_output_file_name}_step{global_step}.npz"
                save(step_file, epoch, epoch, epoch_batches, step=global_step + 1, keep_n=args.keep_n_checkpoints)
            if args.flops_profiler and global_step == 200:
                capture_mod.stop_trace()
                if is_root:
                    print("profiler trace written to ./profile_trace.json; stopping (parity with --flops_profiler)",
                          flush=True)
                return 0
            run.end(global_step)
            global_step += 1
        if epoch_batches == 0:
            raise RuntimeError(f"epoch {epoch} produced no batch from {args.image_text_folder!r}: every shard "
                               "failed to read, or the data is smaller than one batch")
        save(out_file, epoch + 1, epoch + 1, 0)
    if resume_epoch >= args.epochs:
        # the JAX CLI saves once more after its loop; after a last epoch that
        # save would write the file its epoch-end save just wrote
        save(out_file, args.epochs, args.epochs, 0)
    if tele is not None:
        run.flush(logger, step=global_step)
        summary = tele.summary()
        if len(step_s) > 1:  # the first step's time holds the kernels' builds
            flops = dalle_step_flops(cfg, args.batch_size // shares, n_matmul, granularity="tile")
            summary["mfu"] = mfu(flops, statistics.median(step_s[1:]), dtype=compute_dtype, device=device)
        if is_root:
            print(f"[telemetry] run summary: {summary}", flush=True)
    if is_root:
        print(json.dumps({"checkpoint": out_file, "global_step": global_step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
