"""The VAE's data and logging on the CPU: `data/loader.py`'s `ImageDataset`
and `iterate_image_batches`, and `training/logging.py`, against the JAX
package's.

- The dataset lists the same files, and its batches equal the JAX loader's
  bit for bit (same shuffle, same per-item crops), RGB and RGBA, serial and
  on two worker threads, and sliced across processes.
- Without PIL a JPEG in the folder is refused by name, up front.
- `make_grid` equals JAX's; the logger writes the JAX logger's JSONL
  records and PNG grids of the same pixels (read back through PIL), and
  falls back to JSONL when wandb does not import."""
import json
import sys

import numpy as np
import pytest

from dalle_pytorch_tpu_torch.data import loader as tl
from dalle_pytorch_tpu_torch.training import logging as tlog
from torch_data_refs import write_pairs

Image = pytest.importorskip("PIL.Image")
jl = pytest.importorskip("dalle_pytorch_tpu.data.loader")
jlog = pytest.importorskip("dalle_pytorch_tpu.training.logging")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """14 images of several modes and sizes (PNG and JPEG, one nested), with
    captions the VAE's dataset ignores."""
    root = tmp_path_factory.mktemp("images")
    write_pairs(root, 14, seed=6)
    return root


def test_same_files_as_jax(folder):
    port, ref = tl.ImageDataset(str(folder), 24), jl.ImageDataset(str(folder), 24)
    assert len(port) == len(ref) == 14
    assert port.files == ref.files


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("transparent", [False, True], ids=["rgb", "rgba"])
def test_batches_equal_jax(folder, transparent, workers):
    port = tl.ImageDataset(str(folder), 24, transparent=transparent)
    ref = jl.ImageDataset(str(folder), 24, transparent=transparent)
    got = list(tl.iterate_image_batches(port, 4, seed=3, num_workers=workers))
    want = list(jl.iterate_image_batches(ref, 4, seed=3))
    assert len(got) == len(want) == 3  # 14 images: the ragged tail of 2 dropped
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (4, 24, 24, 4 if transparent else 3)
        np.testing.assert_array_equal(g, w)


def test_process_slices_equal_jax(folder):
    port, ref = tl.ImageDataset(str(folder), 16), jl.ImageDataset(str(folder), 16)
    for index in range(2):
        got = list(tl.iterate_image_batches(port, 3, seed=5, process_index=index, process_count=2))
        want = list(jl.iterate_image_batches(ref, 3, seed=5, process_index=index, process_count=2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    unshuffled = list(tl.iterate_image_batches(port, 7, shuffle=False))
    np.testing.assert_array_equal(np.concatenate(unshuffled),
                                  np.concatenate(list(jl.iterate_image_batches(ref, 7, shuffle=False))))


def test_jpeg_without_pil_is_refused_by_name(folder, monkeypatch):
    monkeypatch.setattr(tl, "_pil_image", lambda: None)
    with pytest.raises(SystemExit, match=r"img005\.jpg.*Queue 1 item 10"):
        tl.ImageDataset(str(folder), 16)


def test_make_grid_equals_jax():
    images = np.random.default_rng(0).random((5, 6, 7, 3)).astype(np.float32)
    for nrow in (1, 2, 4, 8):
        np.testing.assert_array_equal(tlog.make_grid(images, nrow=nrow), jlog.make_grid(images, nrow=nrow))


def _records(path):
    out = []
    for line in open(path):
        record = json.loads(line)
        record.pop("ts")
        out.append(record)
    return out


def test_logger_writes_the_jax_records_and_grids(tmp_path):
    """The same calls on both loggers: the JSONL records equal but for the
    timestamps and the image paths' folder, the PNGs hold the same pixels."""
    rng = np.random.default_rng(1)
    batch, single = rng.random((3, 8, 8, 3)).astype(np.float32), rng.random((8, 8, 1)).astype(np.float32)
    codes = rng.integers(0, 32, 200)
    for pkg, name in ((tlog, "port"), (jlog, "jax")):
        logger = pkg.MetricLogger(run_name=name, log_dir=str(tmp_path))
        logger.log({"loss": 0.25, "temperature": 0.9, "codebook_used": 7, "epoch": 0}, step=0)
        logger.log_images({"original images": batch, "grey": single}, step=100)
        logger.log_histogram("codebook_indices", codes, step=100)
        logger.finish()
    port, ref = _records(tmp_path / "port.metrics.jsonl"), _records(tmp_path / "jax.metrics.jsonl")
    assert len(port) == len(ref) == 3
    for name in ("original images", "grey"):
        p, r = port[1]["images"].pop(name), ref[1]["images"].pop(name)
        assert p.endswith(f"port.images/step100_{name.replace(' ', '_')}.png")
        assert r.endswith(f"jax.images/step100_{name.replace(' ', '_')}.png")
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(r)))
    assert port == ref


def test_logger_without_wandb_falls_back_to_jsonl(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    logger = tlog.MetricLogger(run_name="run", log_dir=str(tmp_path), use_wandb=True)
    logger.log({"loss": 1.5}, step=3)
    logger.finish()
    assert "wandb unavailable" in capsys.readouterr().out
    assert _records(tmp_path / "run.metrics.jsonl") == [{"step": 3, "loss": 1.5}]
