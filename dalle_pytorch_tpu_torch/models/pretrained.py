"""The pretrained VAEs: download, cache and convert once (counterpart of
`dalle_pytorch_tpu/models/pretrained.py`).

OpenAI's dVAE (`encoder.pkl`, `decoder.pkl`) and the taming VQGAN (a
Lightning `.ckpt` and its yaml config) are fetched into a cache directory
on first use and converted once into a v3 checkpoint beside them, which
later runs read with no fetch and no unpickling.  The cache directory is
`$DALLE_PYTORCH_TPU_CACHE` (default `~/.cache/dalle_pytorch_tpu`), the JAX
package's, so that both packages share one converted cache: on a machine
with no network, point it at a directory that holds
`openai_vae_converted.npz` or `vqgan_default_converted.npz`.
`fetcher(url, dst_path)` is injectable; the default is urllib.  The port
runs on one process, so the JAX package's rank barriers have no
counterpart here.

Two readers replace libraries the card's machine lacks:

* `load_yaml`, for the subset of YAML that taming configs use: block
  mappings, block (`- 1`) and flow (`[1, 1, 2]`) sequences of scalars,
  ints, floats, booleans, null and strings (PyYAML's YAML 1.1 rules),
  comments.  Anything else raises.
* `load_torch_file`, for torch files whose pickles name classes of
  packages that may be absent (`dall_e`'s modules, Lightning's
  checkpoint): `torch.load(weights_only=True)` first, and where that
  refuses, a restricted unpickler that admits torch's tensor-rebuild
  globals, numpy's array reconstruction and plain containers, and turns
  every other class (a CapWords name) into an inert stub that keeps the
  state it is given.  Any other global raises, naming it; no global
  outside the allow-list is ever called.
"""
from __future__ import annotations

import _compat_pickle
import functools
import os
import pickle
import re
import types
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

OPENAI_VAE_ENCODER_URL = "https://cdn.openai.com/dall-e/encoder.pkl"
OPENAI_VAE_DECODER_URL = "https://cdn.openai.com/dall-e/decoder.pkl"
VQGAN_VAE_URL = "https://heibox.uni-heidelberg.de/f/140747ba53464f49b476/?dl=1"
VQGAN_VAE_CONFIG_URL = "https://heibox.uni-heidelberg.de/f/6ecf2af6c658432c8298/?dl=1"
VQGAN_FILENAME = "vqgan.1024.model.ckpt"
VQGAN_CONFIG_FILENAME = "vqgan.1024.config.yml"
OPENAI_CONVERTED = "openai_vae_converted.npz"
VQGAN_CONVERTED = "vqgan_default_converted.npz"

# ---------------------------------------------------------------------------
# the taming yaml subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1), for the scalars taming configs hold
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"), "+.inf": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}


class YamlSubsetError(ValueError):
    """Raised on YAML outside the subset `load_yaml` reads."""


def _scalar(text: str, where: int) -> Any:
    if text[:1] in ("'", '"'):
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise YamlSubsetError(f"line {where}: unterminated quoted scalar {text!r}")
        body = text[1:-1]
        if quote == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise YamlSubsetError(f"line {where}: escapes in double-quoted scalars are outside the subset")
        return body
    if text[:1] in ("{", "&", "*", "!", "|", ">", "%", "@", "`") or text == "---":
        raise YamlSubsetError(f"line {where}: {text!r} is outside the yaml subset this reader takes")
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"line {where}: {text!r} is outside the yaml subset this reader takes")
    return text


def _value(text: str, where: int) -> Any:
    """An inline value: a flow sequence of scalars, or a scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"line {where}: unterminated flow sequence {text!r}")
        body = text[1:-1].strip()
        if "[" in body or "{" in body:
            raise YamlSubsetError(f"line {where}: nested flow collections are outside the subset")
        return [_scalar(item.strip(), where) for item in body.split(",")] if body else []
    return _scalar(text, where)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str, int]]:
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlSubsetError(f"line {number}: tab indentation")
        out.append((len(line) - len(line.lstrip(" ")), line.strip(), number))
    return out


def _block(lines, i: int, indent: int):
    """The block node whose lines start at `i` with `indent` -> (value, next i)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
            item, number = lines[i][1][1:].strip(), lines[i][2]
            if not item or (": " in item or item.endswith(":")) and item[:1] not in ("'", '"', "["):
                raise YamlSubsetError(f"line {number}: a sequence item holds a collection")
            seq.append(_value(item, number))
            i += 1
        return seq, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, number = lines[i]
        if content.startswith("- ") or content == "-":
            raise YamlSubsetError(f"line {number}: a sequence item inside a mapping")
        if content.endswith(":"):
            key, rest = content[:-1], ""
        elif ": " in content:
            key, rest = content.split(": ", 1)
        else:
            raise YamlSubsetError(f"line {number}: {content!r} is neither a key nor a sequence item")
        key = _scalar(key.strip(), number)
        rest = rest.strip()
        i += 1
        if rest:
            mapping[key] = _value(rest, number)
        elif i < len(lines) and (lines[i][0] > indent or (lines[i][0] == indent and lines[i][1].startswith("-"))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return mapping, i


def load_yaml(text: str) -> Any:
    """Parse the taming-config subset of YAML (the module docstring); the
    result equals `yaml.safe_load`'s on that subset."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0][0] != 0:
        raise YamlSubsetError(f"line {lines[0][2]}: the document does not start at column 0")
    if len(lines) == 1 and ": " not in lines[0][1] and not lines[0][1].endswith(":") \
            and not lines[0][1].startswith("-"):
        return _value(lines[0][1], lines[0][2])
    value, i = _block(lines, 0, 0)
    if i != len(lines):
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected content at column {lines[i][0]}")
    return value


def parse_taming_yaml(path: str) -> dict:
    """A taming config yaml, unwrapped to its `model` section when the file
    is a whole experiment config."""
    config = load_yaml(Path(path).read_text())
    if isinstance(config, dict) and "model" in config:
        config = config["model"]
    return config


# ---------------------------------------------------------------------------
# torch files whose pickles name absent packages
# ---------------------------------------------------------------------------

_NUMPY_GLOBALS = {
    "numpy.core.multiarray._reconstruct", "numpy._core.multiarray._reconstruct", "numpy.ndarray", "numpy.dtype",
    "numpy.core.multiarray.scalar", "numpy._core.multiarray.scalar",
}


@functools.lru_cache(maxsize=None)
def _allowed_globals() -> Dict[str, Any]:
    from torch._weights_only_unpickler import _get_allowed_globals

    allowed = dict(_get_allowed_globals())
    for name in _NUMPY_GLOBALS:
        module, _, attr = name.rpartition(".")
        try:
            allowed[name] = getattr(__import__(module, fromlist=[attr]), attr)
        except (ImportError, AttributeError):
            pass
    return allowed


class Stub:
    """An object of a class the restricted unpickler does not import: the
    arguments it was built with, the state it was given, and the items or
    elements pickled into it (a dict or list subclass), nothing run."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_stub_args"] = (args, kwargs)

    def __setitem__(self, key, value):
        self.__dict__.setdefault("_stub_items", {})[key] = value

    def __getitem__(self, key):
        return self.__dict__.get("_stub_items", {})[key]

    def append(self, value):
        self.__dict__.setdefault("_stub_list", []).append(value)

    def extend(self, values):
        for value in values:
            self.append(value)

    def __setstate__(self, state):
        self.__dict__["_stub_state"] = state
        if isinstance(state, tuple) and len(state) == 2 and isinstance(state[1], dict):
            state = {**(state[0] or {}), **state[1]}  # (__dict__, __slots__ values)
        if isinstance(state, dict):
            self.__dict__.update(state)


def _stub_class(module: str, name: str) -> type:
    return type(name, (Stub,), {"__module__": f"stub.{module}", "__qualname__": name})


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # protocol-2 pickles name Python 2's modules (`__builtin__`): pickle's own mapping
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        qualified = f"{module}.{name}"
        allowed = _allowed_globals()
        if qualified in allowed:
            return allowed[qualified]
        if name[:1].isupper() and name.isidentifier():
            return _stub_class(module, name)
        raise pickle.UnpicklingError(f"the file refers to {qualified}, which is not on the allow-list; "
                                     "nothing of it was called")


_RESTRICTED_PICKLE = types.SimpleNamespace(__name__="restricted_pickle", Unpickler=_RestrictedUnpickler,
                                           load=lambda f, **kw: _RestrictedUnpickler(f, **kw).load())


def load_torch_file(path) -> Any:
    """A torch save file, on the CPU: through `torch.load(weights_only=True)`
    where it allows the file, else through the restricted unpickler (the
    module docstring)."""
    try:
        return torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        pass
    return torch.load(str(path), map_location="cpu", weights_only=False, pickle_module=_RESTRICTED_PICKLE)


def module_parameters(obj: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The parameters (and persistent buffers) of a pickled `nn.Module`,
    read through its stub's `_parameters`, `_buffers` and `_modules`, under
    the names `state_dict` would give them."""
    state = obj.__dict__
    out: Dict[str, torch.Tensor] = {}
    for table in ("_parameters", "_buffers"):
        for name, value in (state.get(table) or {}).items():
            if isinstance(value, torch.Tensor) and name not in (state.get("_non_persistent_buffers_set") or ()):
                out[prefix + name] = value.detach()
    for name, child in (state.get("_modules") or {}).items():
        if child is not None:
            out.update(module_parameters(child, f"{prefix}{name}."))
    return out


def state_dict_of(obj: Any) -> Dict[str, torch.Tensor]:
    """The weights of a loaded torch file: a Lightning checkpoint's
    `state_dict`, a pickled module's parameters, or the dict itself."""
    if isinstance(obj, dict):
        return dict(obj.get("state_dict", obj))
    if isinstance(obj, torch.nn.Module):
        return obj.state_dict()
    if isinstance(obj, Stub):
        items = obj.__dict__.get("_stub_items")
        return state_dict_of(items) if items is not None else module_parameters(obj)
    raise TypeError(f"a torch file holding {type(obj).__name__} carries no weights this port reads")


# ---------------------------------------------------------------------------
# download, cache, convert once
# ---------------------------------------------------------------------------


def default_cache_dir() -> Path:
    return Path(os.environ.get("DALLE_PYTORCH_TPU_CACHE", os.path.expanduser("~/.cache/dalle_pytorch_tpu")))


def _urllib_fetch(url: str, dst: str) -> None:
    import urllib.request

    with urllib.request.urlopen(url) as src, open(dst, "wb") as out:
        while True:
            buf = src.read(1 << 16)
            if not buf:
                break
            out.write(buf)


def download(url: str, filename: Optional[str] = None, root: Optional[Path] = None,
             fetcher: Optional[Callable[[str, str], None]] = None) -> Path:
    """`url` fetched once into the cache (`root`) as `filename` (the URL's
    last path segment without its query by default): a file already there
    is not fetched again.  The fetch writes `tmp.<filename>` and renames
    it."""
    root = Path(root or default_cache_dir())
    filename = filename or os.path.basename(url.split("?")[0])
    target, tmp = root / filename, root / f"tmp.{filename}"
    if target.exists() and not target.is_file():
        raise RuntimeError(f"{target} exists and is not a regular file")
    if not target.is_file():
        root.mkdir(parents=True, exist_ok=True)
        (fetcher or _urllib_fetch)(url, str(tmp))
        os.rename(tmp, target)
    return target


def _is_legacy_cache(path: Path) -> bool:
    """True iff `path` is not a readable v3 checkpoint (a pre-v3 conversion
    cache, or a torn one): it is converted again, not unpickled."""
    import numpy as np

    try:
        with np.load(str(path), allow_pickle=False) as data:
            return "__format" not in data.files or int(data["__format"]) < 3
    except Exception:
        return True


def _convert_once(converted: Path, convert_fn) -> Tuple[dict, dict]:
    """`convert_fn() -> (trees, meta)` written as a v3 checkpoint at
    `converted` unless a readable one is there already, then read back."""
    from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    if converted.is_file() and _is_legacy_cache(converted):
        converted.unlink()
    if not converted.is_file():
        trees, meta = convert_fn()
        save_checkpoint(str(converted), trees, meta)
    return load_checkpoint(str(converted))


def _cache_hit(converted: Path) -> bool:
    return converted.is_file() and not _is_legacy_cache(converted)


def load_openai_vae_pretrained(cache_dir: Optional[Path] = None,
                               fetcher: Optional[Callable[[str, str], None]] = None):
    """OpenAI's dVAE with no arguments: the converted cache if it is there
    (no fetch), else the two pickles fetched and converted once.  Returns
    (params tree, `OpenAIVAEConfig`)."""
    from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint
    from dalle_pytorch_tpu_torch.models import openai_vae

    root = Path(cache_dir or default_cache_dir())
    converted = root / OPENAI_CONVERTED
    if _cache_hit(converted):
        return load_checkpoint(str(converted))[0]["params"], openai_vae.OpenAIVAEConfig()
    enc = download(OPENAI_VAE_ENCODER_URL, root=root, fetcher=fetcher)
    dec = download(OPENAI_VAE_DECODER_URL, root=root, fetcher=fetcher)

    def convert():
        return {"params": openai_vae.load_openai_vae(str(enc), str(dec))}, {"source": "openai",
                                                                          "class": "OpenAIDiscreteVAE"}

    trees, _ = _convert_once(converted, convert)
    return trees["params"], openai_vae.OpenAIVAEConfig()


def load_vqgan_pretrained(model_path: Optional[str] = None, config_path: Optional[str] = None,
                          cache_dir: Optional[Path] = None, fetcher: Optional[Callable[[str, str], None]] = None):
    """The taming VQGAN: a checkpoint and its yaml (a custom model path
    needs its config path), or the published ImageNet f16-1024 model from
    the converted cache (no fetch), else fetched and converted once.
    Returns (params tree, `VQGANConfig`)."""
    from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint
    from dalle_pytorch_tpu_torch.models import vqgan

    if model_path is not None:
        if config_path is None:
            # the published geometry assumed for a custom checkpoint would mis-convert it
            raise ValueError("a custom vqgan_model_path requires its vqgan_config_path")
        return vqgan.load_vqgan(model_path, parse_taming_yaml(config_path))
    root = Path(cache_dir or default_cache_dir())
    converted = root / VQGAN_CONVERTED
    if _cache_hit(converted):
        trees, meta = load_checkpoint(str(converted))
        return trees["params"], vqgan.VQGANConfig.from_dict(meta["vqgan_config"])
    ckpt = download(VQGAN_VAE_URL, VQGAN_FILENAME, root=root, fetcher=fetcher)
    cfg_file = download(VQGAN_VAE_CONFIG_URL, VQGAN_CONFIG_FILENAME, root=root, fetcher=fetcher)

    def convert():
        params, cfg = vqgan.load_vqgan(str(ckpt), parse_taming_yaml(str(cfg_file)))
        return {"params": params}, {"vqgan_config": cfg.to_dict()}

    trees, meta = _convert_once(converted, convert)
    return trees["params"], vqgan.VQGANConfig.from_dict(meta["vqgan_config"])
