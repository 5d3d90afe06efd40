"""Helpers shared by the port's command lines (counterpart of
`dalle_pytorch_tpu/cli/common.py`)."""
from __future__ import annotations


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
