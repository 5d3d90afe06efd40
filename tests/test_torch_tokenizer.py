"""The port's tokenizer against the JAX package's, on the CPU.

The JAX module splits words with the `regex` package; the port scans
`unicodedata` categories instead (neither `regex` nor stdlib `re`'s `\\p`
may be relied on where the port runs).  Token ids must be equal, on a fixed
prompt set, on every assigned code point, and under a hypothesis property;
the port must also tokenize with `regex` unimportable."""
import json
import os
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dalle_pytorch_tpu.data import tokenizer as jtok
from dalle_pytorch_tpu_torch.data import tokenizer as ttok

regex = pytest.importorskip("regex")  # the JAX module's word splitter

REPO = Path(__file__).resolve().parents[1]
WORDS = regex.compile(jtok._WORD_PATTERN, regex.IGNORECASE)

PROMPTS = [
    "a photo of a cat",
    "A Painting Of An ORANGE Circle, in the style of Van Gogh",
    "don't stop, it's ''s and we'll 've 'M 'LL 'D 'Re",
    "hello!!! ... ?!?! --- (brackets) [and] {braces} @#$%^&*",
    "digits 1234567890 and ²½٣ ¼ Ⅻ ⑦",
    "naïve café résumé été",
    unicodedata.normalize("NFD", "naïve café résumé été"),
    "猫がいる 一只猫 고양이",
    "emoji 🐱🐶 👍🏽 family 👨‍👩‍👧",
    "html &amp; entities &amp;amp; &lt;b&gt; &quot;q&quot; &#39;s",
    "runs   of\twhitespace\n\n and nbsp　ideographic line",
    "separators\x1c\x1d\x1e\x1fkeep",
    "<|startoftext|>a special<|endoftext|>",
    "!<|startoftext|> <|STARTOFTEXT|> <|endoftext|>x",
    "long ſs 'ſ ͅcombining ypogegrammeni aͅb",
    "",
    "   ",
]


_JAX_DEFAULT, _JAX, _PORT = jtok.SimpleTokenizer(), jtok.SimpleTokenizer(use_native=False), ttok.SimpleTokenizer()


@pytest.fixture(scope="module")
def tokenizers():
    return _JAX_DEFAULT, _JAX, _PORT


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_equal_the_jax_tokenizer(tokenizers, prompt):
    jax_default, jax_python, port = tokenizers
    ids = port.encode(prompt)
    assert ids == jax_default.encode(prompt)
    assert ids == jax_python.encode(prompt)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_words_and_cleaning_equal_regex(prompt):
    cleaned = jtok._clean_text(prompt).lower()
    assert ttok._clean_text(prompt).lower() == cleaned
    assert ttok._pre_tokens(cleaned) == WORDS.findall(cleaned)


def test_every_assigned_code_point_splits_as_regex():
    """Each code point the interpreter's Unicode database assigns, alone and
    between letters, digits and punctuation, gives regex's words."""
    chars = [chr(cp) for cp in range(0x110000)
             if unicodedata.category(chr(cp)) not in ("Cs", "Cn")]
    for i in range(0, len(chars), 512):
        text = "a" + "a1!".join(chars[i:i + 512]) + "'"
        assert ttok._pre_tokens(text) == WORDS.findall(text), i


def test_whitespace_is_regex_whitespace():
    """`_clean_text` collapses exactly `regex`'s \\s, which differs from
    str.isspace() on U+001C..U+001F."""
    space = regex.compile(r"\s")
    want = {chr(cp) for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF and space.fullmatch(chr(cp))}
    assert ttok._WHITESPACE == want
    assert {c for c in map(chr, range(0x20)) if c.isspace()} - want == set(map(chr, range(0x1C, 0x20)))


_PIECES = st.sampled_from(["<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d",
                           "'", "<", "|", "ſ", "ͅ", "\x1c", " ", "\t", "　", "&amp;", "²", "½"])
_TEXT = st.lists(st.one_of(st.characters(exclude_categories=("Cs", "Cn")), _PIECES), max_size=40).map("".join)


@settings(max_examples=300, deadline=None)
@given(_TEXT)
def test_ids_equal_under_arbitrary_text(text):
    """Arbitrary text over the code points the interpreter's Unicode
    database assigns (a `regex` built on a newer database can call some
    unassigned ones letters), with the pattern's literals mixed in."""
    ids = _PORT.encode(text)
    assert ids == _JAX.encode(text)
    assert _PORT.decode(ids) == _JAX.decode(ids)


def test_tokenize_pads_truncates_and_refuses(tokenizers):
    _, jax_python, port = tokenizers
    texts = ["a cat", "the quick brown fox jumps over the lazy dog again and again"]
    out = port.tokenize(texts, context_length=8, truncate_text=True)
    np.testing.assert_array_equal(out, jax_python.tokenize(texts, context_length=8, truncate_text=True))
    assert out.dtype == np.int64 and out.shape == (2, 8)
    assert out[0, 2:].tolist() == [0] * 6 and (out[1] != 0).all()
    single = port.tokenize("a cat", context_length=5)
    np.testing.assert_array_equal(single, jax_python.tokenize("a cat", context_length=5))
    with pytest.raises(RuntimeError, match="too long for context length 8"):
        port.tokenize(texts, context_length=8)


def test_decode_equals_the_jax_tokenizer(tokenizers):
    _, jax_python, port = tokenizers
    ids = port.tokenize(PROMPTS[:6], context_length=32, truncate_text=True)
    pad_tokens = {320, 539}
    for row in ids:
        for remove in (True, False):
            assert port.decode(row, remove_start_end=remove) == jax_python.decode(row, remove_start_end=remove)
        assert port.decode(row, pad_tokens=pad_tokens) == jax_python.decode(row, pad_tokens=pad_tokens)
    special = [49406, 320, 1125, 49407]
    assert port.decode(special) == jax_python.decode(special) == "a photo "


def test_default_tokenizer_is_built_once():
    assert ttok.tokenizer is ttok.tokenizer
    assert isinstance(ttok.tokenizer, ttok.SimpleTokenizer) and ttok.tokenizer.vocab_size == 49408
    with pytest.raises(AttributeError):
        ttok.no_such_name


@pytest.mark.parametrize("cls,package", [(ttok.HugTokenizer, "tokenizers"), (ttok.YttmTokenizer, "youtokentome"),
                                          (ttok.ChineseTokenizer, "transformers")])
def test_gated_adapters_need_their_package(monkeypatch, cls, package):
    """The adapters import their package when built, not when the module
    is imported: without it, building one raises ImportError."""
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError):
        cls("vocab.json") if cls is not ttok.ChineseTokenizer else cls()


def test_tokenizes_with_regex_unimportable(tokenizers):
    """Where `regex` is missing the port imports and tokenizes without it,
    and gives the JAX tokenizer's ids."""
    _, jax_python, _ = tokenizers
    code = (
        "import sys, json\n"
        "sys.modules['regex'] = None\n"
        "from dalle_pytorch_tpu_torch.data.tokenizer import SimpleTokenizer\n"
        "prompts = json.loads(sys.stdin.read())\n"
        "tok = SimpleTokenizer()\n"
        "assert 'regex' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(json.dumps([tok.encode(p) for p in prompts]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], input=json.dumps(PROMPTS), capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [jax_python.encode(p) for p in PROMPTS]
