"""A numpy-only reader and writer of the JAX package's v3 checkpoints.

The file is one `.npz`: a JSON meta blob (`__meta`), the format stamp
(`__format`), and per named tree its leaves (`<name>:<i>`), their key paths
(`__paths_<name>`), a JSON structure descriptor of dict/list/tuple/None
containers (`__struct_<name>`) and a dtype sidecar (`__dtypes_<name>`).
Leaves of a dtype numpy lacks (bfloat16, the fp8 family) are stored as
same-width unsigned bit-views; they are decoded here through torch, with no
`ml_dtypes`.  Leaves come back as CPU torch tensors.

Nothing is unpickled: v1 and v2 files, whose tree structure is a pickle, are
refused.  A tree stored without a structure descriptor (an optax
optimizer state, whose nodes are library types) comes back as a
`TreeBundle` of its leaves and their key paths, which the reader checks
against the paths of the state it restores (`training/resume.py`).

`save_checkpoint` writes the same format from trees of dicts (string keys),
lists, tuples and None around tensor, numpy or scalar leaves, and from
`TreeBundle`s, so that the JAX package's `load_checkpoint` reads what the
port trains and its `unflatten_like` restores the port's optimizer state.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Tuple

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


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(trees, meta) of a v3 checkpoint: every tree with a structure
    descriptor as nested dicts/lists of CPU tensors, every other one as a
    `TreeBundle`."""
    with np.load(path, allow_pickle=False) as data:
        fmt = int(data["__format"]) if "__format" in data.files else 1
        if fmt != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {fmt}; this reader takes "
                f"only v{FORMAT_VERSION} (older files store their tree structure "
                "as a pickle, which it never loads)"
            )
        meta = json.loads(bytes(data["__meta"]).decode())
        trees: Dict[str, Any] = {}
        for key in data.files:
            if not key.startswith("__paths_"):
                continue
            name = key[len("__paths_"):]
            skey = f"__struct_{name}"
            paths = json.loads(bytes(data[key]).decode())
            leaves = _load_leaves(data, name, len(paths))
            if skey in data.files:
                trees[name] = _rebuild_pure(json.loads(bytes(data[skey]).decode()), leaves)
            else:
                trees[name] = TreeBundle(paths, leaves)
    return trees, meta


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
