"""Tokenizers (counterpart of `dalle_pytorch_tpu/data/tokenizer.py`).

Four interchangeable tokenizers with one protocol: `tokenize(texts,
context_length, truncate_text) -> zero-padded int64 array`, `encode(text) ->
ids`, `decode(ids, pad_tokens) -> str`; pad id 0 doubles as <bos> (the DALL-E
remaps pads to unique per-position ids, `models/dalle.remap_and_bos`).

`SimpleTokenizer` is a pure-Python byte-level BPE over the public CLIP
vocabulary (49,408 entries).  The merges are read in place from the JAX
package's data file (`VOCAB_PATH`); nothing of that package is imported.

The JAX module splits text into words with the `regex` package's
`\\p{L}` / `\\p{N}` classes.  Neither `regex` nor stdlib `re` (which rejects
`\\p`) may be relied on in the port, so `_pre_tokens` is a scanner over
`unicodedata` categories that splits exactly as that pattern does under
`regex` with IGNORECASE, and `_clean_text` collapses whitespace by
`regex`'s definition of `\\s`, which is not `str.isspace()`'s.  Code points
that the interpreter's Unicode database leaves unassigned are neither
letters nor numbers to the port; a `regex` built on a newer database may call
some of them letters.

The C++ merge engine of the JAX package is not ported (`ROADMAP.md`).  The
Hugging Face, youtokentome and Chinese tokenizers import their packages
inside `__init__`, so a missing package fails there and nowhere else;
`ftfy` is used when it imports.
"""
from __future__ import annotations

import functools
import html
import re
import unicodedata
from pathlib import Path
from typing import List, Optional, Sequence, Set, Union

import numpy as np

try:
    import ftfy as _ftfy
except ImportError:  # pragma: no cover
    _ftfy = None

VOCAB_PATH = str(Path(__file__).resolve().parents[2] / "dalle_pytorch_tpu" / "data" / "vocab"
                 / "bpe_simple_vocab_16e6.txt")

# `regex`'s \s: the Unicode White_Space code points.  str.isspace() also
# takes U+001C..U+001F, which \s does not.
_WHITESPACE = frozenset(map(chr, (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                                    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
_WHITESPACE_RUN = re.compile("[" + "".join(re.escape(c) for c in sorted(_WHITESPACE)) + "]+")

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# U+0345 (a combining mark, Mn) case-folds to a letter (iota): under
# IGNORECASE `[^\s\p{L}\p{N}]` refuses it and `[\p{L}]` does not take it,
# so no alternative of the pattern matches there and it is skipped.
_UNMATCHED = frozenset("\u0345")


def _fold(c: str) -> str:
    """The character the pattern's ASCII literals compare against under
    IGNORECASE: ASCII lower case, and U+017F (long s) as "s"."""
    if c == "\u017f":
        return "s"
    return c.lower() if c.isascii() else c


def _literal_at(text: str, i: int, literal: str) -> bool:
    return len(text) - i >= len(literal) and all(_fold(text[i + j]) == ch for j, ch in enumerate(literal))


@functools.lru_cache(maxsize=65536)
def _kind(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace or unmatched, 'O' other."""
    if c in _WHITESPACE or c in _UNMATCHED:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _pre_tokens(text: str) -> List[str]:
    """The words `regex.findall` gives for the JAX module's `_WORD_PATTERN`
    with IGNORECASE: at each position the leftmost alternative that matches
    (a special token, a contraction, a run of letters, one number
    character, a run of what is neither whitespace, letter nor number);
    positions where none matches are skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        word = None
        if c == "<":
            word = next((s for s in _SPECIALS if _literal_at(text, i, s)), None)
        elif c == "'":
            word = next((s for s in _CONTRACTIONS if _literal_at(text, i, s)), None)
        if word is not None:
            out.append(text[i:i + len(word)])
            i += len(word)
            continue
        kind = _kind(c)
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # a number is one character; letters and others run
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _byte_to_unicode() -> dict:
    """Invertible byte -> printable-unicode-char table (the GPT-2 byte-level
    BPE alphabet).  Insertion order matters: the vocab lists the printable
    bytes first, then the remapped ones, and token ids depend on it."""
    visible = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in visible}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


def _clean_text(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE_RUN.sub(" ", text)
    return text.strip()


def _pad_batch(all_tokens: List[List[int]], texts, context_length: int, truncate_text: bool) -> np.ndarray:
    result = np.zeros((len(all_tokens), context_length), dtype=np.int64)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            if truncate_text:
                tokens = tokens[:context_length]
            else:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length {context_length}"
                )
        result[i, : len(tokens)] = np.asarray(tokens, dtype=np.int64)
    return result


def _to_list(tokens) -> List[int]:
    if hasattr(tokens, "tolist"):
        return [int(t) for t in tokens.tolist()]
    return [int(t) for t in tokens]


class SimpleTokenizer:
    """Byte-level BPE over the public CLIP vocabulary (vocab_size 49408)."""

    def __init__(self, bpe_path: str = VOCAB_PATH):
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}

        lines = Path(bpe_path).read_text(encoding="utf8").split("\n")
        # header line first; the file carries more merges than CLIP uses
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        base = list(self.byte_encoder.values())
        symbols = base + [c + "</w>" for c in base]
        symbols += ["".join(pair) for pair in merges]
        symbols += list(_SPECIALS)

        self.encoder = {sym: i for i, sym in enumerate(symbols)}
        self.decoder = {i: sym for sym, i in self.encoder.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}
        self.vocab_size = len(symbols)
        if self.vocab_size != 49408:
            raise ValueError(f"{bpe_path} gives {self.vocab_size} symbols, not CLIP's 49408")
        self._cache = {}

    def _merge_word(self, token: str) -> List[str]:
        """Apply the merges to one byte-mapped pre-token, lowest rank first;
        the last symbol carries </w>."""
        if token in self._cache:
            return self._cache[token]
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranks = [self.merge_rank.get(pair) for pair in zip(parts, parts[1:])]
            live = [r for r in ranks if r is not None]
            if not live:
                break
            best = min(live)
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and ranks[i] == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        text = _clean_text(text).lower()
        ids: List[int] = []
        for word in _pre_tokens(text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[sym] for sym in self._merge_word(mapped))
        return ids

    def decode(self, tokens, remove_start_end: bool = True, pad_tokens: Set[int] = frozenset()) -> str:
        tokens = _to_list(tokens)
        if remove_start_end:
            specials = {self.encoder[s] for s in _SPECIALS} | {0}
            tokens = [t for t in tokens if t not in specials]
        text = "".join(self.decoder[t] for t in tokens if t not in pad_tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 256, truncate_text: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_batch([self.encode(t) for t in texts], texts, context_length, truncate_text)


class HugTokenizer:
    """A Hugging Face `tokenizers` BPE from its json file."""

    def __init__(self, bpe_path: Optional[str] = None):
        from tokenizers import Tokenizer
        from tokenizers.processors import ByteLevel

        path = Path(bpe_path)
        if not path.exists():
            raise FileNotFoundError(f"BPE json path {path} does not exist")
        tok = Tokenizer.from_file(str(path))
        tok.post_processor = ByteLevel(trim_offsets=True)
        self.tokenizer = tok
        self.vocab_size = tok.get_vocab_size()

    def decode(self, tokens, pad_tokens: Set[int] = frozenset()) -> str:
        tokens = [t for t in _to_list(tokens) if t not in set(pad_tokens) | {0}]
        return self.tokenizer.decode(tokens, skip_special_tokens=True)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text).ids

    def tokenize(self, texts, context_length: int = 256, truncate_text: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_batch([self.encode(t) for t in texts], texts, context_length, truncate_text)


class ChineseTokenizer:
    """`transformers`' BertTokenizer (`bert-base-chinese` by default)."""

    def __init__(self, model_name: str = "bert-base-chinese"):
        from transformers import BertTokenizer

        self.tokenizer = BertTokenizer.from_pretrained(model_name)
        self.vocab_size = self.tokenizer.vocab_size

    def decode(self, tokens, pad_tokens: Set[int] = frozenset()) -> str:
        tokens = [t for t in _to_list(tokens) if t not in set(pad_tokens) | {0}]
        return self.tokenizer.decode(tokens)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def tokenize(self, texts, context_length: int = 256, truncate_text: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_batch([self.encode(t) for t in texts], texts, context_length, truncate_text)


class YttmTokenizer:
    """A youtokentome BPE model."""

    def __init__(self, bpe_path: Optional[str] = None):
        import youtokentome as yttm

        path = Path(bpe_path)
        if not path.exists():
            raise FileNotFoundError(f"BPE model path {path} does not exist")
        self.tokenizer = yttm.BPE(model=str(path))
        self.vocab_size = self.tokenizer.vocab_size()
        self._yttm = yttm

    def decode(self, tokens, pad_tokens: Set[int] = frozenset()) -> str:
        return self.tokenizer.decode(_to_list(tokens), ignore_ids=set(pad_tokens) | {0})

    def encode(self, texts: Union[str, Sequence[str]]):
        single = isinstance(texts, str)
        out = self.tokenizer.encode([texts] if single else list(texts), output_type=self._yttm.OutputType.ID)
        return out[0] if single else out

    def tokenize(self, texts, context_length: int = 256, truncate_text: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_batch(self.encode(texts), texts, context_length, truncate_text)


@functools.lru_cache(maxsize=1)
def _default() -> SimpleTokenizer:
    return SimpleTokenizer()


def __getattr__(name: str):
    # `tokenizer`, the module's default SimpleTokenizer (the JAX module's
    # singleton), built at first use rather than at import
    if name == "tokenizer":
        return _default()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
