"""The JAX package's pre-v3 checkpoints (`__treedef_<name>`: a pickled
`PyTreeDef`) through the port's `checkpoint.load_checkpoint`, on the CPU:
v1 and v2 files written with the JAX package as its own tests write them
read leaf for leaf equal to the JAX loader's trees under
`allow_legacy_pickle`, refused without it, and a hostile global or a node
kind the reader does not rebuild refused by name with nothing run.  Also
the JAX-free writer of `tests/torch_port_refs.py` against JAX's own pickle."""
import json
import pickle
from collections import namedtuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu.training import checkpoint as jckpt  # noqa: E402
from dalle_pytorch_tpu_torch import checkpoint as tckpt  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae_registry  # noqa: E402
from torch_port_refs import treedef_pickle, write_legacy_checkpoint  # noqa: E402

TREE = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "l": [np.ones(2, np.int32), (np.zeros(1, np.float32), None)],
        "d": {"b": np.full((2,), 7, np.int64), "a": np.array(1.5, np.float32)}, "n": None}


def _jax_legacy(path, tree, fmt, dtypes=None):
    """A legacy file as the JAX package's tests write one
    (`tests/test_checkpoint.py`): its treedef pickled by JAX."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    payload = {
        "__meta": np.frombuffer(json.dumps({"epoch": 4}).encode(), dtype=np.uint8),
        "__treedef_w": np.frombuffer(pickle.dumps(treedef), dtype=np.uint8),
        "__dtypes_w": np.frombuffer(json.dumps(dtypes or [np.asarray(x).dtype.name for x in leaves]).encode(),
                                    dtype=np.uint8),
    }
    for i, leaf in enumerate(leaves):
        payload[f"w:{i}"] = np.asarray(leaf)
    if fmt is not None:
        payload["__format"] = np.array(fmt, dtype=np.int64)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def _same(port, ref):
    if isinstance(ref, dict):
        assert type(port) is dict and set(port) == set(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _same(p, r)
    elif ref is None:
        assert port is None
    else:
        assert isinstance(port, torch.Tensor) and tuple(port.shape) == np.shape(ref)
        np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("fmt", [None, 2], ids=["v1", "v2"])
def test_legacy_files_read_like_the_jax_loader(tmp_path, fmt):
    path = tmp_path / "legacy.npz"
    _jax_legacy(path, TREE, fmt)
    ref, ref_meta = jckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    trees, meta = tckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    assert meta == ref_meta == {"epoch": 4}
    _same(trees["w"], ref["w"])
    assert trees["w"]["l"][0].dtype == torch.int32 and trees["w"]["d"]["b"].dtype == torch.int64


@pytest.mark.parametrize("fmt", [None, 2], ids=["v1", "v2"])
def test_legacy_files_need_the_opt_in(tmp_path, fmt):
    path = tmp_path / "legacy.npz"
    _jax_legacy(path, TREE, fmt)
    with pytest.raises(ValueError, match=f"legacy v{fmt or 1} .*allow_legacy_pickle"):
        tckpt.load_checkpoint(str(path))
    with pytest.raises(ValueError, match="allow_legacy_pickle"):
        jckpt.load_checkpoint(str(path))


def test_bf16_leaves_come_through_the_dtype_sidecar(tmp_path):
    bits = np.array([0x3F80, 0xC000, 0x4049], np.uint16)  # 1.0, -2.0, 3.140625
    path = tmp_path / "bf16.npz"
    _jax_legacy(path, {"w": bits}, 2, dtypes=["bfloat16"])
    ref, _ = jckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    trees, _ = tckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    assert trees["w"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(trees["w"]["w"].float().numpy(), np.asarray(ref["w"]["w"], np.float32))
    np.testing.assert_array_equal(trees["w"]["w"].float().numpy(), [1.0, -2.0, 3.140625])


class _Hostile:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        import os

        return os.system, (f"touch {self.marker}",)


def test_a_hostile_treedef_is_refused_and_never_run(tmp_path):
    marker = tmp_path / "ran"
    payload = {"__meta": np.frombuffer(b"{}", dtype=np.uint8), "__format": np.array(2, dtype=np.int64),
               "__treedef_w": np.frombuffer(pickle.dumps(_Hostile(marker)), dtype=np.uint8)}
    path = tmp_path / "evil.npz"
    np.savez(path, **payload)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system"):
        tckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    assert not marker.exists()


Pair = namedtuple("Pair", "a b")


def test_a_node_kind_it_does_not_rebuild_is_named(tmp_path):
    path = tmp_path / "named.npz"
    _jax_legacy(path, {"p": Pair(np.ones(1, np.float32), np.zeros(1, np.float32))}, 2)
    with pytest.raises((ValueError, pickle.UnpicklingError), match="kind 3|Pair"):
        tckpt.load_checkpoint(str(path), allow_legacy_pickle=True)


def test_the_jax_free_writer_pickles_what_jax_pickles(tmp_path):
    tree = {**TREE, "t": (np.ones(1, np.float32),), "e": [], "m": {}}
    assert pickle.loads(treedef_pickle(tree)) == jax.tree_util.tree_structure(tree)
    path = tmp_path / "written.npz"
    write_legacy_checkpoint(path, {"w": tree}, {"epoch": 1}, fmt=2)
    ref, _ = jckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    trees, _ = tckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    _same(trees["w"], ref["w"])


def test_a_v2_dalle_checkpoint_loads_into_the_port(tmp_path):
    """A whole DALL-E and its VAE in a v2 file: the models the port loads
    from it hold the JAX loader's trees."""
    jcfg = jdalle.DALLEConfig(dim=32, depth=2, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7,
                              num_image_tokens=16, image_fmap_size=2)
    vcfg = jvae.DiscreteVAEConfig(image_size=8, num_tokens=16, codebook_dim=8, num_layers=2, hidden_dim=8)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    vparams = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(1), vcfg))
    meta = {"hparams": jcfg.to_dict(), "vae_params": vcfg.to_dict(), "vae_class_name": "DiscreteVAE",
            "version": "0.0.1"}
    path = tmp_path / "dalle_v2.npz"
    write_legacy_checkpoint(path, {"weights": params, "vae_weights": vparams}, meta, fmt=2)
    with pytest.raises(ValueError, match="allow_legacy_pickle"):
        weights.load_dalle_checkpoint(path, "cpu")
    model, vae = weights.load_dalle_checkpoint(path, "cpu", allow_legacy_pickle=True)
    ref, _ = jckpt.load_checkpoint(str(path), allow_legacy_pickle=True)
    _same(weights.dalle_tree(model.state_dict(), model.cfg), ref["weights"])
    _same(weights.vae_tree(vae.state_dict(), vae.cfg), ref["vae_weights"])
    codes = np.random.default_rng(0).integers(0, 16, (1, 4))
    np.testing.assert_allclose(vae_registry.decode_indices(vae, torch.from_numpy(codes)).numpy(), np.asarray(
        jvae.decode_indices(vparams, vcfg, jnp.asarray(codes.astype(np.int32)))), atol=1e-5, rtol=0)
