"""The port stands alone: it imports neither JAX nor the JAX package, runs
with JAX made unimportable, and never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "dalle_pytorch_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dalle_pytorch_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["dalle_pytorch_tpu"] = None
import torch
from dalle_pytorch_tpu_torch import DALLE, DiscreteVAE
vae = DiscreteVAE(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8, device="cpu")
dalle = DALLE(vae=vae, dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=7, device="cpu")
images = dalle.generate_images(torch.randint(1, 40, (2, 7)), cond_scale=2.0)
assert images.shape == (2, 16, 16, 3) and torch.isfinite(images).all()
assert not any(m == "jax" or m.startswith(("jax.", "dalle_pytorch_tpu.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_default_device_without_a_card_raises(monkeypatch):
    from dalle_pytorch_tpu_torch import DALLE, DiscreteVAE
    from dalle_pytorch_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiscreteVAE(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)
    vae = DiscreteVAE(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8,
                      device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DALLE(vae=vae, dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


SERVING_MODULES = ("models.paged", "serving.kv_pool", "serving.scheduler", "serving.lanes", "serving.engine",
                   "tools.loadgen", "cli.serve")


def test_serving_runs_with_jax_unimportable():
    """The serving modules import, and the engine and the service serve,
    with JAX and the JAX package made unimportable; `cli.serve` refuses to
    run without a card unless asked for the CPU."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["dalle_pytorch_tpu"] = None
import torch
for name in {SERVING_MODULES!r}:
    importlib.import_module("dalle_pytorch_tpu_torch." + name)
from dalle_pytorch_tpu_torch.cli import serve
report = serve.main(["--synthetic", "--loadgen", "2", "--rate", "100", "--dim", "64", "--image_fmap_size", "2",
                     "--block_size", "4", "--device", "cpu"])
assert report["requests_completed"] == 2
torch.cuda.is_available = lambda: False
try:
    serve.main(["--synthetic", "--loadgen", "1"])
except RuntimeError as e:
    assert "no CUDA device" in str(e)
else:
    raise AssertionError("served without a card")
assert not any(m == "jax" or m.startswith(("jax.", "dalle_pytorch_tpu.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
