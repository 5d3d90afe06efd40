"""Helpers shared by the port's command lines (counterpart of
`dalle_pytorch_tpu/cli/common.py`)."""
from __future__ import annotations

# the generate and serve CLIs' loader of any checkpoint format, as in the
# JAX package; it lives with the weight converters it feeds
from dalle_pytorch_tpu_torch.weights import load_dalle_bundle  # noqa: F401


def warn_vocab_mismatch(num_text_tokens: int, tokenizer) -> None:
    """Out-of-vocab caption ids are clamped by the model
    (`models/dalle.remap_and_bos`); say so at every entry point that pairs
    a tokenizer with a model."""
    vocab = getattr(tokenizer, "vocab_size", None)
    if vocab is not None and num_text_tokens < vocab:
        print(
            f"WARNING: model num_text_tokens {num_text_tokens} < tokenizer vocab "
            f"{vocab}; out-of-range caption ids will be clamped onto the last "
            f"vocab id — check --num_text_tokens / tokenizer choice"
        )


def refuse(what: str, item: int) -> SystemExit:
    """The exit of a flag or input whose machinery the port does not have
    yet, naming its ROADMAP.md Queue 1 item."""
    return SystemExit(f"{what} is not ported yet; it comes with a later PR of the port (ROADMAP.md Queue 1 item "
                      f"{item})")


def add_distributed_flags(parser) -> None:
    """The JAX CLIs' distributed-backend flags (`parallel/backend.py`
    `wrap_arg_parser`); any value but the default exits naming Queue 1
    item 7 (`refuse_distributed`)."""
    parser.add_argument("--distributed_backend", "--distr_backend", type=str, default="none",
                        help="none (the only backend ported); others wait for ROADMAP.md Queue 1 item 7")
    for name, kind in (("coordinator_address", str), ("num_processes", int), ("process_id", int)):
        parser.add_argument(f"--{name}", type=kind, default=None, help="distributed training (Queue 1 item 7)")


def refuse_distributed(args) -> None:
    if args.distributed_backend.lower() != "none":
        raise refuse(f"--distributed_backend {args.distributed_backend}: distributed training", 7)
    for name in ("coordinator_address", "num_processes", "process_id"):
        if getattr(args, name) is not None:
            raise refuse(f"--{name}: distributed training", 7)
