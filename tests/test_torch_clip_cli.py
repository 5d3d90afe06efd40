"""The port's CLIP training CLI (`cli/train_clip.py`) on the CPU, at the
JAX CLI test's sizes (dim 32, one layer a side, 16 px in patches of 8).

- It trains on a folder of images and captions and writes `clip.pt`, which
  loads through the JAX `load_checkpoint`; its weights give the same
  scores in JAX as in the port (1e-5 relative).
- Each step prints its record (the clipped grad norm at most 0.5); the
  loss goes to `clip.metrics.jsonl` every 10 steps.
- `--zero_stage`, `--mesh_*` and the distributed flags exit naming
  ROADMAP.md Queue 1 item 7."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import clip as jclip  # noqa: E402
from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load  # noqa: E402
from dalle_pytorch_tpu_torch import checkpoint, weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_clip as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import clip as tclip  # noqa: E402
from torch_data_refs import write_pairs  # noqa: E402

# tests/test_cli.py's `test_train_clip_cli` sizes
SIZES = ["--dim_text", "32", "--dim_image", "32", "--dim_latent", "16", "--text_enc_depth", "1", "--text_seq_len",
         "16", "--text_heads", "2", "--visual_enc_depth", "1", "--visual_heads", "2", "--visual_image_size", "16",
         "--visual_patch_size", "8", "--truncate_captions"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("clip_cli")
    write_pairs(ws / "data", 16, seed=9)
    return ws


@pytest.fixture(scope="module")
def trained(workspace):
    """Two epochs of two steps of 8, a step checkpoint every 3 steps."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["--image_text_folder", str(workspace / "data"), *SIZES, "--epochs", "2", "--batch_size",
                          "8", "--save_every_n_steps", "3", "--clip_output_file_name", str(workspace / "clip"),
                          "--device", "cpu"]) == 0
    return [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]


def test_trains_and_logs(workspace, trained):
    steps = [r for r in trained if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3] and all(np.isfinite(r["loss"]) for r in steps)
    assert all(r["grad_norm"] <= 0.5 * (1 + 1e-5) and r["skipped"] == 0 for r in steps)
    assert trained[0]["config"]["num_text_tokens"] == 49408  # the default tokenizer's vocabulary
    records = [json.loads(line) for line in open(workspace / "clip.metrics.jsonl")]
    assert [(r["step"], r["epoch"]) for r in records] == [(0, 0)]
    assert records[0]["loss"] == steps[0]["loss"]
    assert trained[-1] == {"checkpoint": str(workspace / "clip.pt"), "global_step": 4}


def test_checkpoint_gives_the_same_scores_in_jax(workspace, trained):
    trees, meta = jax_load(str(workspace / "clip.pt"))
    assert sorted(meta) == ["hparams", "version"]
    jcfg = jclip.CLIPConfig(**meta["hparams"])
    ptrees, pmeta = checkpoint.load_checkpoint(str(workspace / "clip.pt"))
    model = weights.load_clip(ptrees["weights"], tclip.CLIPConfig(**pmeta["hparams"]), device="cpu")
    rng = np.random.default_rng(2)
    text = rng.integers(1, 49408, (3, 16))
    text[1, 5:] = 0
    images = rng.random((3, 16, 16, 3), dtype=np.float32)
    mask = text != 0
    ref = jclip.forward(jax.tree_util.tree_map(jnp.asarray, trees["weights"]), jcfg, jnp.asarray(text.astype(np.int32)),
                        jnp.asarray(images), text_mask=jnp.asarray(mask))
    with torch.no_grad():
        port = tclip.forward(model, torch.from_numpy(text), torch.from_numpy(images), torch.from_numpy(mask))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


def test_both_clis_learn_pairs_whose_captions_name_the_image(tmp_path):
    """The pairs of `chip_smoke.py`'s `train_clip_cli` (colour and pattern
    named by the caption), at this file's sizes with 32 px images: eight
    steps of the port's CLI and of the JAX CLI, same data and seed, each
    lower the contrastive loss on the first batch by more than 0.1 (a run
    that does not update stays at its first loss to rounding).  The two
    initialise differently (torch's generator, JAX's threefry), so the
    losses are compared with each side's own start."""
    import contextlib
    import io

    from chip_smoke import write_caption_pairs
    from dalle_pytorch_tpu.cli import train_clip as jcli
    from dalle_pytorch_tpu.data import loader as jloader
    from dalle_pytorch_tpu.data import tokenizer as jtokenizer

    write_caption_pairs(tmp_path, seed=74, hw=(40, 44), band=4)
    sizes = SIZES[: SIZES.index("--visual_image_size")] + ["--visual_image_size", "32", "--visual_patch_size", "8",
                                                           "--truncate_captions"]
    common = ["--image_text_folder", str(tmp_path / "pairs"), *sizes, "--epochs", "8", "--save_every_n_steps", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main([*common, "--clip_output_file_name", str(tmp_path / "port"), "--device", "cpu"]) == 0
        _, jcfg = jcli.main([*common, "--clip_output_file_name", str(tmp_path / "jax")])
    dataset = jloader.TextImageDataset(str(tmp_path / "pairs"), text_len=16, image_size=32, truncate_captions=True,
                                       tokenizer=jtokenizer.tokenizer, shuffle=True)
    batch = next(jloader.iterate_batches(dataset, 16, seed=42))
    text, images = jnp.asarray(batch["text"]), jnp.asarray(batch["image"])

    def loss(params):
        return float(jclip.forward(params, jcfg, text, images, text_mask=text != 0, return_loss=True))

    port_start = tclip.init_clip(tclip.CLIPConfig(**jcfg.to_dict()), torch.Generator().manual_seed(42), "cpu")
    starts = {"port": weights.clip_tree(port_start.state_dict(), port_start.cfg),
              "jax": jclip.init_clip(jax.random.PRNGKey(42), jcfg)}
    for name, start in starts.items():
        trained = jax.tree_util.tree_map(jnp.asarray, jax_load(str(tmp_path / f"{name}.pt"))[0]["weights"])
        start = jax.tree_util.tree_map(jnp.asarray, start)
        assert loss(trained) < loss(start) - 0.1, (name, loss(start), loss(trained))
