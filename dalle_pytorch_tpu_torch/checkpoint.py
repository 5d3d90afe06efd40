"""A numpy-only reader and writer of the JAX package's v3 checkpoints.

The file is one `.npz`: a JSON meta blob (`__meta`), the format stamp
(`__format`), and per named tree its leaves (`<name>:<i>`), their key paths
(`__paths_<name>`), a JSON structure descriptor of dict/list/tuple/None
containers (`__struct_<name>`) and a dtype sidecar (`__dtypes_<name>`).
Leaves of a dtype numpy lacks (bfloat16, the fp8 family) are stored as
same-width unsigned bit-views; they are decoded here through torch, with no
`ml_dtypes`.  Leaves come back as CPU torch tensors.

A v3 file is read without unpickling anything.  v1 and v2 files store
each tree's structure as a pickled JAX `PyTreeDef` (`__treedef_<name>`);
they are refused unless the caller opts in with `allow_legacy_pickle`, and
even then nothing of the pickle runs: a restricted unpickler admits the
`PyTreeDef` class and `jax._src.tree_util.default_registry` as inert
stubs, reads the post-order list of node tuples `(kind, arity,
node_data, ..., num_leaves, num_nodes)` the treedef keeps as its state,
and rebuilds leaves, None, tuples, lists and dicts; any other node kind
or global raises, naming it.  A tree stored without a structure
descriptor (an optax optimizer state, whose nodes are library types) comes
back as a `TreeBundle` of its leaves and their key paths, which the reader
checks against the paths of the state it restores (`training/resume.py`).

`save_checkpoint` writes the same format from trees of dicts (string keys),
lists, tuples and None around tensor, numpy or scalar leaves, and from
`TreeBundle`s, so that the JAX package's `load_checkpoint` reads what the
port trains and its `unflatten_like` restores the port's optimizer state.
"""
from __future__ import annotations

import io
import json
import os
import pickle
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 3

# dtype names numpy lacks -> (signed view of the stored bits, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.int8, torch.float8_e4m3fn),
    "float8_e5m2": (np.int8, torch.float8_e5m2),
}


class TreeBundle(NamedTuple):
    """The leaves of a tree whose node types live in a library (an optax
    state) and their key paths, in the JAX package's encoding: per leaf a
    list of ["k", key] (dict key), ["i", index] (sequence index) and ["a",
    name] (named-tuple field) segments, in its flatten order."""

    paths: List[List]
    leaves: List[Any]


def _leaf(arr: np.ndarray, want) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # ascontiguousarray gives a 0-d leaf one dim
    if want is not None and arr.dtype.name != want:
        if want not in _BIT_VIEWS:
            raise ValueError(f"leaf stored as {arr.dtype.name} for dtype {want}, which this reader cannot decode")
        view, tdtype = _BIT_VIEWS[want]
        return torch.from_numpy(arr.view(view)).view(tdtype)
    return torch.from_numpy(arr)


def _load_leaves(data, name: str, n: int) -> List[torch.Tensor]:
    dkey = f"__dtypes_{name}"
    dtypes = json.loads(bytes(data[dkey]).decode()) if dkey in data.files else [None] * n
    return [_leaf(data[f"{name}:{i}"], dtypes[i]) for i in range(n)]


def _rebuild_pure(desc, leaves):
    kind = desc["_"]
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[desc["i"]]
    if kind == "dict":
        return {k: _rebuild_pure(v, leaves) for k, v in desc["items"]}
    if kind == "list":
        return [_rebuild_pure(v, leaves) for v in desc["items"]]
    if kind == "tuple":
        return tuple(_rebuild_pure(v, leaves) for v in desc["items"])
    raise ValueError(f"unknown structure node {kind!r}")


# a pickled treedef's globals: the class in each jaxlib layout, and the registry
_TREEDEF_CLASSES = {("jaxlib._jax.pytree", "PyTreeDef"), ("jaxlib.xla_extension.pytree", "PyTreeDef"),
                    ("jaxlib.xla_extension", "PyTreeDef"), ("jaxlib._jax", "PyTreeDef")}
_REGISTRY = ("jax._src.tree_util", "default_registry")
# PyTreeKind: leaf, None, tuple, namedtuple, list, dict, custom, dataclass
_LEAF, _NONE, _TUPLE, _LIST, _DICT = 0, 1, 2, 4, 5


class _TreeDefStub:
    """Stands in for a pickled `PyTreeDef`: keeps the state BUILD gives it."""

    def __setstate__(self, state):
        self.state = state


class _Registry:
    pass


class _TreeDefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _TREEDEF_CLASSES:
            return _TreeDefStub
        if (module, name) == _REGISTRY:
            return _Registry()
        raise pickle.UnpicklingError(f"a legacy treedef refers to {module}.{name}, which it may not hold")


def _read_treedef(blob: bytes) -> List[tuple]:
    """The post-order node list of a pickled `PyTreeDef`."""
    obj = _TreeDefUnpickler(io.BytesIO(blob)).load()
    state = getattr(obj, "state", None)
    if not isinstance(obj, _TreeDefStub) or not (isinstance(state, tuple) and len(state) == 2
                                                 and isinstance(state[1], list)):
        raise ValueError(f"a legacy treedef pickle holds {type(obj).__name__}, not a PyTreeDef's state")
    return state[1]


def _unflatten_nodes(nodes: List[tuple], leaves: list):
    """Rebuild a tree from its post-order node list and its leaves."""
    stack, it = [], iter(leaves)
    for node in nodes:
        kind, arity, data = node[0], node[1], node[2]
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == _LEAF:
            stack.append(next(it))
        elif kind == _NONE:
            stack.append(None)
        elif kind == _TUPLE:
            stack.append(tuple(children))
        elif kind == _LIST:
            stack.append(list(children))
        elif kind == _DICT:
            stack.append(dict(zip(data, children)))
        else:
            raise ValueError(f"a legacy treedef holds a node of kind {kind} (a named tuple, a custom or "
                             "dataclass node), which this reader does not rebuild")
    if len(stack) != 1:
        raise ValueError(f"a legacy treedef left {len(stack)} roots")
    return stack[0]


def _num_leaves(nodes: List[tuple]) -> int:
    return sum(node[0] == _LEAF for node in nodes)


def load_checkpoint(path: str, allow_legacy_pickle: bool = False,
                    names: Optional[Tuple[str, ...]] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(trees, meta) of a checkpoint: every tree with a structure
    descriptor as nested dicts/lists of CPU tensors, every other one as a
    `TreeBundle`; with `names`, only those trees are read (inference reads
    the weights and not a training run's optimizer moments).  A v1/v2 file
    needs `allow_legacy_pickle` (its structure is a pickle; the module
    docstring says how little of it is read)."""
    with np.load(path, allow_pickle=False) as data:
        fmt = int(data["__format"]) if "__format" in data.files else 1
        if fmt > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {fmt}, newer than this "
                f"reader's {FORMAT_VERSION}; upgrade the library to read it"
            )
        meta = json.loads(bytes(data["__meta"]).decode())
        trees: Dict[str, Any] = {}
        if fmt < FORMAT_VERSION:
            if not allow_legacy_pickle:
                raise ValueError(
                    f"checkpoint {path!r} has format version {fmt}: it is a legacy v{fmt} file whose tree "
                    "structure is stored as a pickle — refusing to unpickle by default (a crafted file could "
                    "execute code on load).  If the file comes from a trusted source, load it with "
                    "load_checkpoint(path, allow_legacy_pickle=True) and re-save it to migrate to the "
                    "pickle-free v3 format (save_checkpoint writes v3)."
                )
            for key in data.files:
                name = key[len("__treedef_"):]
                if key.startswith("__treedef_") and (names is None or name in names):
                    nodes = _read_treedef(bytes(data[key]))
                    trees[name] = _unflatten_nodes(nodes, _load_leaves(data, name, _num_leaves(nodes)))
            return trees, meta
        for key in data.files:
            name = key[len("__paths_"):]
            if not key.startswith("__paths_") or (names is not None and name not in names):
                continue
            skey = f"__struct_{name}"
            paths = json.loads(bytes(data[key]).decode())
            leaves = _load_leaves(data, name, len(paths))
            if skey in data.files:
                trees[name] = _rebuild_pure(json.loads(bytes(data[skey]).decode()), leaves)
            else:
                trees[name] = TreeBundle(paths, leaves)
    return trees, meta


def is_sharded_checkpoint(path) -> bool:
    """True iff `path` is an orbax sharded checkpoint directory."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "state"))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

# torch dtypes numpy lacks -> the unsigned view of their bits and the dtype
# name the JAX package's reader decodes the view back into
_TORCH_BIT_VIEWS = {
    torch.bfloat16: (torch.int16, np.uint16, "bfloat16"),
    torch.float8_e4m3fn: (torch.int8, np.uint8, "float8_e4m3fn"),
    torch.float8_e5m2: (torch.int8, np.uint8, "float8_e5m2"),
}


def _flatten(tree, path, paths, leaves):
    """The JSON structure descriptor of a pure tree, in the JAX package's
    flatten order (dict keys sorted); appends key paths and leaves."""
    if tree is None:
        return {"_": "none"}
    if type(tree) is dict:
        if not all(isinstance(key, str) for key in tree):
            raise TypeError("checkpoint tree dicts take string keys only")
        return {"_": "dict", "items": [[key, _flatten(tree[key], path + [["k", key]], paths, leaves)]
                                       for key in sorted(tree)]}
    if type(tree) in (list, tuple):
        kind = "list" if type(tree) is list else "tuple"
        return {"_": kind, "items": [_flatten(v, path + [["i", i]], paths, leaves)
                                     for i, v in enumerate(tree)]}
    paths.append(path)
    leaves.append(tree)
    return {"_": "leaf", "i": len(leaves) - 1}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(stored array, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype in _TORCH_BIT_VIEWS:
            signed, unsigned, name = _TORCH_BIT_VIEWS[t.dtype]
            return t.view(signed).numpy().view(unsigned), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_checkpoint(path: str, trees: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write named pure trees (or `TreeBundle`s) and JSON meta as one v3
    `.npz`, atomically:
    to `<path>.tmp`, flushed and fsynced, then renamed over `path` (and the
    directory fsynced), so a crash leaves the old file or the new one."""
    payload = {"__meta": _json_bytes(meta), "__format": np.array(FORMAT_VERSION, dtype=np.int64)}
    for name, tree in trees.items():
        if tree is None:
            continue
        if isinstance(tree, TreeBundle):
            paths, leaves, struct = tree.paths, tree.leaves, None
        else:
            paths, leaves = [], []
            struct = _flatten(tree, [], paths, leaves)
        dtypes = []
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_numpy(leaf)
            payload[f"{name}:{i}"] = arr
            dtypes.append(dtype)
        payload[f"__paths_{name}"] = _json_bytes(paths)
        if struct is not None:
            payload[f"__struct_{name}"] = _json_bytes(struct)
        payload[f"__dtypes_{name}"] = _json_bytes(dtypes)
    path = str(path)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
