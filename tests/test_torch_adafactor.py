"""The port's grouped optimizers against optax, on the CPU.

`optim.adafactor.Adafactor` against `optax.adafactor(lr)` at optax's
defaults over 5 steps on a tree with factored leaves (both dims >= 128, in
either order), unfactored ones (1-D, 64 x 256, a LayerScale-shaped 3-D
leaf), a zero-initialised leaf (the parameter-scale floor of 1e-3) and a
large gradient (the block-RMS clipping); `optim.grouped.Adam` (the
optimizer of the training CLI's bf16 storage) against `optax.adam`.  The
statistics stay f32 and match optax's."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from optax._src import factorized  # noqa: E402

from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor, factored_dims  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402

REL = 1e-6  # f32, the same operations in the same order up to rsqrt vs ** -0.5
SHAPES = {
    "factored_wide": (128, 300),  # rows are the second-largest dim
    "factored_tall": (256, 128),  # columns are
    "factored_twin": (256, 128),  # shares a group with factored_tall
    "vector": (17,),
    "narrow": (64, 256),  # second-largest 64 < 128: unfactored
    "layerscale": (1, 1, 32),
    "zero": (130, 140),  # zero-initialised: the 1e-3 floor of the parameter scale
}
CLIPPED = "factored_wide"  # its gradient is 1e3 times the others


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small products gain nothing from torch's threads, and where the suite
    runs in several processes those threads only compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(rng, scale=0.05):
    tree = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    tree["zero"][:] = 0
    return tree


def _grads(rng):
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    g[CLIPPED] = g[CLIPPED] * 1e3
    g["narrow"][:, :5] = 0  # columns that saw no gradient
    return g


def _rel(port, ref) -> float:
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _updates(port, state, grads, params):
    """One `step_groups` of the port, its f32 updates by leaf name."""
    out = {}
    port.step_groups(state, grads, params, lambda names, p32, u32: out.update(zip(names, u32.unbind(0))))
    return out


def _run(tx, port, steps=5, group_elements=None):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    if group_elements is not None:
        port.group_elements = group_elements
    js, ts = tx.init(jp), port.init(tp)
    worst = 0.0
    for _ in range(steps):
        g = _grads(rng)
        ju, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu = _updates(port, ts, {k: torch.from_numpy(v) for k, v in g.items()}, tp)
        for k in SHAPES:
            assert tu[k].dtype == torch.float32 and tu[k].shape == SHAPES[k]
            worst = max(worst, _rel(tu[k].numpy(), np.asarray(ju[k])))
        jp = optax.apply_updates(jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    return worst, js, ts


@pytest.mark.parametrize("group_elements", [None, 1], ids=["grouped", "one_leaf_a_group"])
def test_adafactor_matches_optax(group_elements):
    """Five steps within 1e-6 relative, whether same-shape leaves share a
    group or each has its own; the port's statistics are f32 and equal
    optax's factored rows and columns and full second moments."""
    worst, js, ts = _run(optax.adafactor(1e-3), Adafactor(1e-3), group_elements=group_elements)
    assert worst <= REL, worst
    assert ts.count == 5
    fs = next(s for s in js if isinstance(s, factorized.FactoredState))
    stats = {}
    for group in ts.groups:
        for key, stacked in group.stats.items():
            assert stacked.dtype == torch.float32
            stats.update({(name, key): t for name, t in zip(group.names, stacked.unbind(0))})
    for name, shape in SHAPES.items():
        dims = factored_dims(shape)
        keys = ("v",) if dims is None else ("v_row", "v_col")
        for key in keys:
            ref = np.asarray(getattr(fs, key)[name])
            assert _rel(stats[(name, key)].numpy(), ref) <= REL, (name, key)
    if group_elements is None:  # the two 256 x 128 leaves share one group
        assert any(g.names == ("factored_tall", "factored_twin") for g in ts.groups)


def test_adafactor_clips_and_floors():
    """The first step's update of the clipped leaf has block RMS lr (the
    threshold 1 times lr times the parameter scale); the zero leaf's update
    has RMS lr * 1e-3 (the floor)."""
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    grads = {k: torch.from_numpy(v) for k, v in _grads(rng).items()}
    port = Adafactor(1e-3)
    updates = _updates(port, port.init(params), grads, params)
    rms = lambda t: float(t.square().mean().sqrt())  # noqa: E731
    p_rms = rms(params[CLIPPED])
    assert rms(updates[CLIPPED]) == pytest.approx(1e-3 * p_rms, rel=1e-5)
    assert rms(updates["zero"]) <= 1e-3 * 1e-3 * (1 + 1e-5)


@pytest.mark.parametrize("shape", [(5,), (128, 128), (127, 300), (300, 127), (128, 3, 200), (2, 130, 129),
                                   (1, 1, 1152), (4608, 1152)])
def test_factored_dims_match_optax(shape):
    assert factored_dims(shape) == factorized._factored_dims(shape, True, 128)


def test_grouped_adam_matches_optax():
    """The training CLI's Adam under bf16 storage (`optim.grouped.Adam`)
    against `optax.adam`, five steps, 1e-6 relative."""
    worst, _, ts = _run(optax.adam(1e-3), Adam(1e-3))
    assert worst <= REL, worst
    assert ts.count == 5 and all(t.dtype == torch.float32 for g in ts.groups for t in g.stats.values())
