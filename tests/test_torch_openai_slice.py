"""The slice as a whole on the CPU through OpenAI's dVAE at its fixed
geometry (256 px, 8,192 tokens, a 32 x 32 code map), batch 1: one train
step of a small DALL-E through the frozen dVAE, then an image primed from
pixels completed under injected noise, against the JAX package
(`tests/test_torch_vae_families.py` holds the body and its tolerances)."""
import pytest

pytest.importorskip("jax")
from test_torch_vae_families import one_step_then_primed_codes, one_torch_thread  # noqa: E402,F401


def test_one_step_then_primed_codes_equal_jax():
    one_step_then_primed_codes("openai")
